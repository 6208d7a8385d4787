"""Device milliseconds inside the ``vit_attention`` ranges (the vision
towers' plain attention, ``layers.attention_chunked``: its f32 logits
products and softmax) per image encoded in the traced chunk."""


def read(layer):
    tr = layer.get("trace")
    if tr is None or not layer.get("images"):
        return None
    seconds, spans = tr.span_s("vit_attention")
    if spans == 0 or seconds <= 0:
        return None
    return seconds * 1e3 / layer["images"]

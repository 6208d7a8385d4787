"""The served text path's share of the card's bf16 peak over the window:
the model FLOPs of each micro-batch's real prompt tokens
(``flops.decoder_forward``) over the host clock of the encoder call that
served it (it ends in the copy back), summed over the window's calls, in
%."""


def read(layer):
    calls = layer.get("encode_calls")
    if not calls:
        return None
    seconds = sum(c["seconds"] for c in calls)
    if seconds <= 0:
        return None
    return 100.0 * sum(c["flops"] for c in calls) / seconds \
        / layer["peak_flops"]

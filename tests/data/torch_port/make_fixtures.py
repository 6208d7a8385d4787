"""Write the fixtures of ``chip_smoke.py``'s files phase into this
directory. Run from the repository root where Pillow, ``tokenizers`` and
``transformers`` are installed (the card machine has none of them):

    python tests/data/torch_port/make_fixtures.py

- ``jpeg/<h>x<w>.jpg``: one JPEG for each of the eight served image sizes
  (``chip_smoke.IMAGE_SIZES``), smooth seeded content (gradients, discs,
  mild noise), baseline and progressive, 4:2:0 and 4:4:4 in turn, and two
  640 x 480 4:2:0 files, ``480x640_baseline.jpg`` and
  ``480x640_progressive.jpg``, that the phase times; ``images.json``:
  each file's mode and the SHA-256 of Pillow's decode
  (``np.asarray(Image.open(f).convert("RGB")).tobytes()``).
- ``llama3_tokenizer/``: a byte-level BPE in Llama 3's layout (its split
  regex, ``ignore_merges``, a BOS post-processor, the 256 special tokens
  at 128,000-128,255 with ``<image>`` at 128,255, the id the registry's
  LLaVA-NeXT-Llama3-8B expects), trained on seeded captions and filled
  to 128,000 model tokens with entries no text can produce;
  ``tokenizer.json`` is stored xz-compressed. ``ids.json`` pins
  ``transformers``' ids of fixed texts with and without special tokens.
"""

import hashlib
import io
import json
import lzma
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

IMAGE_SIZES = ((375, 500), (500, 375), (640, 640), (300, 1000), (1000, 300),
               (720, 1280), (300, 600), (600, 300))
LLAMA3_RX = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
             r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)"
             r"|\s+")
LLAMA3_CHAT = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + "
    "'<|end_header_id|>\n\n'+ message['content'] | trim + '<|eot_id|>' %}"
    "{% if loop.index0 == 0 %}{% set content = bos_token + content %}"
    "{% endif %}{{ content }}{% endfor %}{% if add_generation_prompt %}"
    "{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}")
WORDS = ("a an the dog dogs cat man woman girl boy child people two three "
         "red blue green white black young old small large running sits "
         "stands plays playing walking riding holding looking wearing on "
         "in at of with near by under street grass water beach snow park "
         "field road bike ball shirt hat dress car bus train tree building "
         "table food camera group crowd stage music guitar jumps climbs "
         "smiles it's isn't they're 2 10 2024 café").split()
BASE_VOCAB, N_SPECIAL = 128_000, 256
SPECIALS = {0: "<|begin_of_text|>", 1: "<|end_of_text|>",
            6: "<|start_header_id|>", 7: "<|end_header_id|>",
            9: "<|eot_id|>", 255: "<image>"}


def smooth_image(seed, h, w):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([x / w * 255, y / h * 255, (x + y) / (h + w) * 255], -1)
    for _ in range(6):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(3, max(h, w) / 3 + 4)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 2, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def captions(seed, n):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, int(rng.integers(5, 14))))
            for _ in range(n)]


def write_images():
    from PIL import Image, features

    os.makedirs(os.path.join(HERE, "jpeg"), exist_ok=True)
    meta = {"pillow": Image.__version__,
            "libjpeg_turbo": features.version("libjpeg_turbo"), "files": {}}
    files = [(f"{h}x{w}.jpg", h, w, i % 2 == 1,
              "4:2:0" if i % 4 < 2 else "4:4:4")
             for i, (h, w) in enumerate(IMAGE_SIZES)]
    files += [(f"480x640_{kind}.jpg", 480, 640, kind == "progressive",
               "4:2:0") for kind in ("baseline", "progressive")]
    for i, (name, h, w, progressive, subsampling) in enumerate(files):
        buf = io.BytesIO()
        Image.fromarray(smooth_image(100 + i, h, w)).save(
            buf, "JPEG", quality=85, progressive=progressive,
            subsampling=2 if subsampling == "4:2:0" else 0)
        with open(os.path.join(HERE, "jpeg", name), "wb") as f:
            f.write(buf.getvalue())
        pixels = np.asarray(Image.open(io.BytesIO(buf.getvalue()))
                            .convert("RGB"))
        meta["files"][name] = {
            "shape": list(pixels.shape), "progressive": progressive,
            "subsampling": subsampling,
            "sha256": hashlib.sha256(pixels.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "images.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.write("\n")


def pinned_texts():
    from mllm_sparse_retrieval_tpu_torch.models import templates

    tmpl = templates.LLAMA3
    return captions(7, 24) + [
        tmpl.expand_image(tmpl.image_prompt(), 4),
        tmpl.fill_text(tmpl.text_prompt(), "a dog runs on the grass"),
        "Don't it'S 12345 café 東京 🙂  two  spaces\n\nnew lines",
        "<|begin_of_text|>x<image><image>y<|eot_id|>"]


def write_tokenizer():
    from tokenizers import (Regex, Tokenizer, decoders, models,
                            pre_tokenizers, trainers)
    from transformers import AutoTokenizer, PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_RX), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(captions(0, 4000), trainers.BpeTrainer(
        vocab_size=3000, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    data = json.loads(tok.to_str())
    vocab = data["model"]["vocab"]
    # filler entries: "␀" is no byte-level character, so no text maps
    # to them (the ids between the trained vocabulary and the specials)
    for i in range(len(vocab), BASE_VOCAB):
        vocab[f"␀{i}"] = i
    names = [SPECIALS.get(i, f"<|reserved_special_token_{i}|>")
             for i in range(N_SPECIAL)]
    data["added_tokens"] = [
        {"id": BASE_VOCAB + i, "content": c, "single_word": False,
         "lstrip": False, "rstrip": False, "normalized": False,
         "special": True} for i, c in enumerate(names)]
    data["post_processor"] = {"type": "Sequence", "processors": [
        {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
         "use_regex": True},
        {"type": "TemplateProcessing",
         "single": [{"SpecialToken": {"id": "<|begin_of_text|>",
                                      "type_id": 0}},
                    {"Sequence": {"id": "A", "type_id": 0}}],
         "pair": [{"SpecialToken": {"id": "<|begin_of_text|>",
                                    "type_id": 0}},
                  {"Sequence": {"id": "A", "type_id": 0}},
                  {"SpecialToken": {"id": "<|begin_of_text|>",
                                    "type_id": 1}},
                  {"Sequence": {"id": "B", "type_id": 1}}],
         "special_tokens": {"<|begin_of_text|>": {
             "id": "<|begin_of_text|>", "ids": [BASE_VOCAB],
             "tokens": ["<|begin_of_text|>"]}}}]}
    full = Tokenizer.from_str(json.dumps(data))
    assert full.token_to_id("<image>") == BASE_VOCAB + 255
    fast = PreTrainedTokenizerFast(
        tokenizer_object=full, bos_token="<|begin_of_text|>",
        eos_token="<|eot_id|>", pad_token="<|end_of_text|>")
    fast.chat_template = LLAMA3_CHAT
    out = os.path.join(HERE, "llama3_tokenizer")
    with tempfile.TemporaryDirectory() as tmp:
        fast.save_pretrained(tmp)
        os.makedirs(out, exist_ok=True)
        for name in sorted(os.listdir(tmp)):
            with open(os.path.join(tmp, name), "rb") as f:
                raw = f.read()
            if name == "tokenizer.json":
                with open(os.path.join(out, name + ".xz"), "wb") as f:
                    f.write(lzma.compress(raw, preset=9))
            else:
                with open(os.path.join(out, name), "wb") as f:
                    f.write(raw)
        hf = AutoTokenizer.from_pretrained(tmp)
        pinned = {"vocab_size": len(hf), "pad_id": hf.pad_token_id,
                  "texts": [[t, hf.encode(t), hf.encode(
                      t, add_special_tokens=False)] for t in pinned_texts()]}
    assert pinned["vocab_size"] == BASE_VOCAB + N_SPECIAL
    with open(os.path.join(HERE, "ids.json"), "w") as f:
        json.dump(pinned, f, ensure_ascii=False)
        f.write("\n")


if __name__ == "__main__":
    write_images()
    write_tokenizer()

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
- ``llama2_spm/``: a sentencepiece ``tokenizer.model`` alone, in the shape
  of Llama 2's (Vicuna's, LLaVA-1.5's): ``<unk>``, control ``<s>`` and
  ``</s>``, the 256 byte pieces, 3,000 merged pieces scored by merge
  order (a BPE trained on seeded captions, then pieces joined at random)
  and the single characters last, BPE with ``byte_fallback``,
  ``add_dummy_prefix`` and the identity normalizer, written with the
  protobuf descriptor ``transformers`` bundles; with a Vicuna-style
  ``tokenizer_config.json`` (``legacy`` false, the specials as AddedToken
  dicts). ``spm_ids.json`` pins ``transformers``' ids of fixed texts.
  Where ``sentencepiece`` is not installed, ``transformers`` converts the
  model through ``StandInSentencePiece``, which only reports the file's piece
  table (the merges, normalizer and post-processor stay ``transformers``'
  own).
"""

import hashlib
import importlib
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


SPM_CHARS = list(dict.fromkeys(
    sorted(set("".join(WORDS))) + list("▁.,!?-ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                                      "0123456789éüßñ東京")))
VICUNA_CONFIG = {
    "add_bos_token": True, "add_eos_token": False,
    "bos_token": {"__type": "AddedToken", "content": "<s>", "lstrip": False,
                  "normalized": False, "rstrip": False, "single_word": False},
    "clean_up_tokenization_spaces": False,
    "eos_token": {"__type": "AddedToken", "content": "</s>",
                  "lstrip": False, "normalized": False, "rstrip": False,
                  "single_word": False},
    "legacy": False, "model_max_length": 4096, "pad_token": None,
    "padding_side": "right", "sp_model_kwargs": {},
    "tokenizer_class": "LlamaTokenizer",
    "unk_token": {"__type": "AddedToken", "content": "<unk>",
                  "lstrip": False, "normalized": False, "rstrip": False,
                  "single_word": False}}


def write_spm_model(path, seed=0, n_merges=3000, model_type=2):
    """A Llama-2-shaped sentencepiece model at ``path``: each merged piece
    joins two earlier pieces (``▁`` only at a piece's start), scored by
    its merge order; ``model_type`` 2 is BPE, 1 Unigram."""
    from transformers.utils import sentencepiece_model_pb2_new as pb

    rng = np.random.default_rng(seed)
    m = pb.ModelProto()

    def add(piece, score, kind):
        p = m.pieces.add()
        p.piece, p.score, p.type = piece, score, kind

    add("<unk>", 0.0, 2)
    add("<s>", 0.0, 3)
    add("</s>", 0.0, 3)
    for b in range(256):
        add(f"<0x{b:02X}>", 0.0, 6)
    pieces, have, merged = list(SPM_CHARS), set(SPM_CHARS), []
    # the merges of a BPE trained on seeded captions first, then pieces
    # joined at random up to ``n_merges``
    words = {}
    for caption in captions(seed, 500):
        for w in caption.split():
            words["▁" + w] = words.get("▁" + w, 0) + 1
    seqs = {w: list(w) for w in words}
    while True:
        pairs = {}
        for w, n in words.items():
            for pair in zip(seqs[w], seqs[w][1:]):
                pairs[pair] = pairs.get(pair, 0) + n
        if not pairs:
            break
        a, b = max(pairs, key=lambda q: (pairs[q], q))
        for w, seq in seqs.items():
            i, out = 0, []
            while i < len(seq):
                if i + 1 < len(seq) and (seq[i], seq[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            seqs[w] = out
        if a + b not in have:
            have.add(a + b)
            pieces.append(a + b)
            merged.append(a + b)
    while len(merged) < n_merges:
        a = pieces[int(rng.integers(len(pieces)))]
        b = SPM_CHARS[int(rng.integers(len(SPM_CHARS)))] \
            if rng.random() < 0.7 else pieces[int(rng.integers(len(pieces)))]
        w = a + b
        if "▁" in w[1:] or len(w) > 10 or w in have:
            continue
        have.add(w)
        pieces.append(w)
        merged.append(w)
    for i, w in enumerate(merged):
        add(w, -float(i), 1)
    for j, c in enumerate(SPM_CHARS):
        add(c, -float(n_merges + j), 1)
    m.trainer_spec.model_type = model_type
    m.trainer_spec.vocab_size = len(m.pieces)
    m.trainer_spec.byte_fallback = True
    m.trainer_spec.unk_id, m.trainer_spec.bos_id = 0, 1
    m.trainer_spec.eos_id, m.trainer_spec.pad_id = 2, -1
    m.normalizer_spec.name = "identity"
    m.normalizer_spec.add_dummy_prefix = True
    m.normalizer_spec.remove_extra_whitespaces = False
    with open(path, "wb") as f:
        f.write(m.SerializeToString())


class StandInSentencePiece:
    """What ``LlamaTokenizer`` and ``LlamaConverter`` call on a
    ``sentencepiece.SentencePieceProcessor``, from the file's piece table
    alone: loading, the piece count, id <-> piece and the special ids. It
    encodes nothing."""

    def __init__(self, **_):
        self.m = None

    def Load(self, path):
        with open(path, "rb") as f:
            self.LoadFromSerializedProto(f.read())

    def LoadFromSerializedProto(self, data):
        from transformers.utils import sentencepiece_model_pb2_new as pb

        self.m = pb.ModelProto.FromString(data)
        self._ids = {p.piece: i for i, p in enumerate(self.m.pieces)}

    def GetPieceSize(self):
        return len(self.m.pieces)

    def id_to_piece(self, i):
        return self.m.pieces[i].piece

    def piece_to_id(self, piece):
        return self._ids.get(piece, self.m.trainer_spec.unk_id)

    def serialized_model_proto(self):
        return self.m.SerializeToString()

    def bos_id(self):
        return self.m.trainer_spec.bos_id

    def eos_id(self):
        return self.m.trainer_spec.eos_id

    def unk_id(self):
        return self.m.trainer_spec.unk_id

    def pad_id(self):
        return self.m.trainer_spec.pad_id

    load, get_piece_size = Load, GetPieceSize
    IdToPiece, PieceToId = id_to_piece, piece_to_id


def stand_in_patches():
    """``(target, name, value)`` triples that let ``transformers`` convert
    a sentencepiece model without ``sentencepiece``: the stand-in module (with the bundled
    protobuf descriptor as its ``sentencepiece_model_pb2``), the
    availability flag, the slow class behind ``LlamaTokenizerFast`` and
    the slow module's ``spm`` (bound to whatever ``sentencepiece`` was
    when a process first imported it). Apply them in order (the module
    before the slow class's import)."""
    import types

    from transformers.utils import import_utils
    from transformers.utils import sentencepiece_model_pb2_new as pb

    mod = types.ModuleType("sentencepiece")
    mod.SentencePieceProcessor = StandInSentencePiece
    mod.sentencepiece_model_pb2 = pb
    yield sys.modules, "sentencepiece", mod
    yield import_utils, "_sentencepiece_available", True
    # an earlier import without sentencepiece may have left None in place
    # of the slow module
    name = "transformers.models.llama.tokenization_llama"
    if name in sys.modules and sys.modules[name] is None:
        del sys.modules[name]
    tokenization_llama = importlib.import_module(name)
    tokenization_llama_fast = importlib.import_module(name + "_fast")
    yield tokenization_llama, "spm", mod
    yield (tokenization_llama_fast.LlamaTokenizerFast,
           "slow_tokenizer_class", tokenization_llama.LlamaTokenizer)


def spm_texts():
    """Texts for the pinned ids: captions, and leading, repeated and
    trailing spaces, bytes the model lacks, the specials' text."""
    return captions(11, 12) + [
        " a dog  runs   on the grass ", "  two leading", "tab\there",
        "Crème brûlée ½ 🙂 Ωmega 東京", "<s>a</s><unk>b <s> c",
        "USER: <image>\nDescribe. ASSISTANT:"]


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


def write_spm_tokenizer():
    from transformers import AutoTokenizer

    out = os.path.join(HERE, "llama2_spm")
    os.makedirs(out, exist_ok=True)
    write_spm_model(os.path.join(out, "tokenizer.model"))
    with open(os.path.join(out, "tokenizer_config.json"), "w") as f:
        json.dump(VICUNA_CONFIG, f, indent=2)
        f.write("\n")
    for target, name, value in stand_in_patches():
        if isinstance(target, dict):
            target[name] = value
        else:
            setattr(target, name, value)
    hf = AutoTokenizer.from_pretrained(out)
    pinned = {"vocab_size": len(hf),
              "texts": [[t, hf.encode(t), hf.encode(
                  t, add_special_tokens=False)] for t in spm_texts()]}
    with open(os.path.join(HERE, "spm_ids.json"), "w") as f:
        json.dump(pinned, f, ensure_ascii=False)
        f.write("\n")


if __name__ == "__main__":
    write_images()
    write_tokenizer()
    write_spm_tokenizer()

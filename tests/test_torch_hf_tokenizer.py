"""PyTorch port: the ``tokenizer.json`` reader (``models/hf_tokenizer.py``)
against ``transformers``.

Four tokenizers are trained here with ``tokenizers`` on seeded captions (no
download) and saved through ``PreTrainedTokenizerFast.save_pretrained``
with added, special and pad tokens and a chat template:

- ``llama3``: byte-level BPE with the Llama-3 split regex (Isolated) and
  ``ignore_merges``, a TemplateProcessing BOS;
- ``qwen2``: byte-level BPE with the Qwen2 split regex and NFC, the
  Qwen2.5-VL and InternVL2.5 specials;
- ``llama2_prepend``: Llama-2-style BPE with ``byte_fallback`` and
  ``fuse_unk``, normalized by Prepend("▁") + Replace(" ", "▁");
- ``llama2_metaspace``: the same model behind Metaspace (prepend scheme
  "first", no split).

Each also carries a normalized added token, an ``lstrip`` / ``rstrip``
token and a ``single_word`` token. Exact: the ids of every text with and
without special tokens, ``get_vocab``, ``vocab_size``, ``pad_id`` and the
rendered chat template equal the JAX package's ``HFTokenizerAdapter`` over
``AutoTokenizer.from_pretrained(dir)``; the chat families' templates
resolved by ``templates.resolve_template`` equal the JAX package's. A
derandomized hypothesis test draws unicode text of digits, whitespace
runs, contractions, emoji and CJK.
"""

import json
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from mllm_sparse_retrieval_tpu.models import templates as jtemplates
from mllm_sparse_retrieval_tpu.models.tokenizer import (
    HFTokenizerAdapter as JAdapter)
from mllm_sparse_retrieval_tpu_torch.models import templates
from mllm_sparse_retrieval_tpu_torch.models.hf_tokenizer import (
    HFJsonTokenizer, translate_regex)

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

LLAMA3_RX = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
             r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)"
             r"|\s+")
QWEN2_RX = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
            r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
WORDS = ("a the dog cat man woman child runs sits on in of with red blue "
         "green grass street ball plays two three people bike water beach "
         "snow tree it's don't they're we've I'm you'll she'd café naïve "
         "東京 北京 狗 猫 1234 56 7 2024 100000 🙂 🐶 — … ‘quoted’ \"x\" (y) "
         "[z] {w} a-b c_d e.f").split()
SEPS = [" ", " ", " ", "  ", "\n", " \n ", "\t", ", ", ". "]
LLAMA3_CHAT = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + "
    "'<|end_header_id|>\n\n'+ message['content'] | trim + '<|eot_id|>' %}"
    "{% if loop.index0 == 0 %}{% set content = bos_token + content %}"
    "{% endif %}{{ content }}{% endfor %}{% if add_generation_prompt %}"
    "{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}")
QWEN2_VL_CHAT = (
    "{% set image_count = namespace(value=0) %}{% for message in messages %}"
    "{% if loop.first and message['role'] != 'system' %}<|im_start|>system\n"
    "You are a helpful assistant.<|im_end|>\n{% endif %}<|im_start|>"
    "{{ message['role'] }}\n{% if message['content'] is string %}"
    "{{ message['content'] }}<|im_end|>\n{% else %}"
    "{% for content in message['content'] %}{% if content['type'] == "
    "'image' or 'image' in content %}"
    "{% set image_count.value = image_count.value + 1 %}"
    "<|vision_start|><|image_pad|><|vision_end|>{% elif 'text' in content %}"
    "{{ content['text'] }}{% endif %}{% endfor %}<|im_end|>\n{% endif %}"
    "{% endfor %}{% if add_generation_prompt %}<|im_start|>assistant\n"
    "{% endif %}")
VICUNA_CHAT = (
    "{% for message in messages %}{% if message['role'] == 'user' %}"
    "{{ 'USER: ' + message['content'] + ' ' }}{% else %}"
    "{{ 'ASSISTANT: ' + message['content'] + eos_token }}{% endif %}"
    "{% endfor %}{% if add_generation_prompt %}{{ 'ASSISTANT:' }}{% endif %}")
KINDS = ("llama3", "qwen2", "llama2_prepend", "llama2_metaspace")
LLAMA3_SPECIALS = ("<|begin_of_text|>", "<|end_of_text|>",
                   "<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>")
QWEN_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>",
                 "<|vision_start|>", "<|vision_end|>", "<|image_pad|>",
                 "<img>", "</img>", "<IMG_CONTEXT>")


def captions(seed, n):
    """Seeded captions over WORDS with mixed separators."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        words = [WORDS[i] for i in rng.integers(0, len(WORDS),
                                                int(rng.integers(3, 14)))]
        text = words[0]
        for w in words[1:]:
            text += SEPS[int(rng.integers(0, len(SEPS)))] + w
        out.append(text)
    return out


def byte_level_tokenizer(kind, caps, vocab_size):
    """A trained byte-level BPE (``llama3`` or ``qwen2``), before its added
    tokens."""
    from tokenizers import (Regex, Tokenizer, decoders, models, normalizers,
                            pre_tokenizers, trainers)

    tok = Tokenizer(models.BPE(ignore_merges=kind == "llama3"))
    if kind == "qwen2":
        tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_RX if kind == "llama3"
                                   else QWEN2_RX), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False,
                                 use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(caps, trainers.BpeTrainer(
        vocab_size=vocab_size, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    return tok


def llama2_tokenizer(kind, caps, vocab_size):
    """A Llama-2-style BPE with byte fallback (``<0x00>``...``<0xFF>`` in
    the model vocab only) and ``fuse_unk``."""
    from tokenizers import (Regex, Tokenizer, models, normalizers,
                            pre_tokenizers, trainers)

    base = Tokenizer(models.BPE(unk_token="<unk>"))
    base.pre_tokenizer = pre_tokenizers.Split(Regex("▁[^▁]*|[^▁]+"),
                                              behavior="isolated")
    base.train_from_iterator(
        ["▁" + c.replace(" ", "▁") for c in caps],
        trainers.BpeTrainer(
            vocab_size=vocab_size, show_progress=False, limit_alphabet=60,
            special_tokens=["<unk>", "<s>", "</s>"]
            + [f"<0x{b:02X}>" for b in range(256)]))
    d = json.loads(base.to_str())
    d["model"].update(byte_fallback=True, fuse_unk=True)
    d["added_tokens"] = [t for t in d["added_tokens"]
                         if t["content"] in ("<unk>", "<s>", "</s>")]
    tok = Tokenizer.from_str(json.dumps(d))
    if kind == "llama2_prepend":
        tok.normalizer = normalizers.Sequence([
            normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
        tok.pre_tokenizer = None
    else:
        tok.normalizer = None
        tok.pre_tokenizer = pre_tokenizers.Metaspace(
            replacement="▁", prepend_scheme="first", split=False)
    return tok


def build_tokenizer(kind, out_dir, seed=0, vocab_size=900):
    """Train, add tokens, save with ``save_pretrained``; returns out_dir."""
    from tokenizers import AddedToken, processors
    from transformers import PreTrainedTokenizerFast

    caps = captions(seed, 400)
    if kind in ("llama3", "qwen2"):
        tok = byte_level_tokenizer(kind, caps, vocab_size)
        if kind == "llama3":
            tok.add_special_tokens(list(LLAMA3_SPECIALS) + ["<image>"])
            bos = tok.token_to_id("<|begin_of_text|>")
            tok.post_processor = processors.Sequence([
                processors.ByteLevel(trim_offsets=False),
                processors.TemplateProcessing(
                    single="<|begin_of_text|> $A",
                    pair="<|begin_of_text|> $A <|begin_of_text|> $B:1",
                    special_tokens=[("<|begin_of_text|>", bos)])])
            kw = dict(bos_token="<|begin_of_text|>", eos_token="<|eot_id|>",
                      pad_token="<|end_of_text|>")
            chat = LLAMA3_CHAT
        else:
            tok.add_special_tokens(list(QWEN_SPECIALS))
            tok.post_processor = processors.ByteLevel(trim_offsets=False)
            kw = dict(eos_token="<|im_end|>", pad_token="<|endoftext|>")
            chat = QWEN2_VL_CHAT
        tok.add_tokens([AddedToken(" hello world", normalized=True),
                        AddedToken("<mask>", lstrip=True, normalized=False),
                        AddedToken("zz", single_word=True,
                                   normalized=False)])
    else:
        tok = llama2_tokenizer(kind, caps, vocab_size)
        tok.post_processor = processors.TemplateProcessing(
            single="<s> $A", pair="<s> $A <s> $B",
            special_tokens=[("<s>", tok.token_to_id("<s>"))])
        tok.add_special_tokens(["<image>", "<pad>"])
        tok.add_tokens([AddedToken("snow tree", normalized=True),
                        AddedToken("<mask>", lstrip=True, rstrip=True,
                                   normalized=False)])
        kw = dict(bos_token="<s>", eos_token="</s>", unk_token="<unk>",
                  pad_token="<pad>")
        chat = VICUNA_CHAT
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, **kw)
    fast.chat_template = chat
    fast.save_pretrained(str(out_dir))
    return out_dir


@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    """kind -> (the reader, the JAX package's adapter over AutoTokenizer)."""
    from transformers import AutoTokenizer

    root = tmp_path_factory.mktemp("tok")
    out = {}
    for kind in KINDS:
        d = build_tokenizer(kind, root / kind)
        out[kind] = (HFJsonTokenizer.from_dir(str(d)),
                     JAdapter(AutoTokenizer.from_pretrained(str(d))))
    return out


TEXTS = captions(99, 60) + [
    "", " ", "  leading", "trailing  ", "a<image>b", "x <mask> y",
    "x  <mask>  y", "zz a zz", "azz zz_", "hello world hello  world",
    "snow tree snow  tree", "<s>hi</s>", "Å NFC Å", "don't DON'T It'S",
    "12345678 9", "🙂🙂 🐶", "東京タワー", "\r\n\r\n x", "x　y z",
    "\x1c\x1d\x1e x", "<0x41>", "ſ 's 'ſ", "<|im_start|>user\nhi<|im_end|>",
    "<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\nhi",
    "<image>" * 5 + "\nSummary above image in one word: ",
    " nbsp thin math", "tab\tand\u000bvt"]


@pytest.mark.parametrize("kind", KINDS)
def test_ids_vocab_pad_and_size_equal_transformers(toks, kind):
    mine, theirs = toks[kind]
    for text in TEXTS:
        for add in (True, False):
            assert mine.encode(text, add) == theirs.encode(text, add), \
                (text, add)
    assert mine.get_vocab() == theirs.get_vocab()
    assert mine.vocab_size == theirs.vocab_size
    assert mine.pad_id == theirs.pad_id
    ids, mask = mine.pad_batch([mine.encode(t) for t in TEXTS[:5]])
    jids, jmask = theirs.pad_batch([theirs.encode(t) for t in TEXTS[:5]])
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)


@pytest.mark.parametrize("kind", KINDS)
def test_chat_template_renders_as_transformers(toks, kind):
    mine, theirs = toks[kind]
    for messages in ([{"role": "user", "content": "hi <image> there"}],
                     [{"role": "user", "content": " a "},
                      {"role": "assistant", "content": "b"},
                      {"role": "user", "content": "c"}]):
        for gen in (True, False):
            assert mine.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=gen) == \
                theirs.hf_tokenizer.apply_chat_template(
                    messages, tokenize=False, add_generation_prompt=gen)
    assert mine.apply_chat_template(messages, tokenize=True) == \
        theirs.hf_tokenizer.apply_chat_template(messages, tokenize=True)


@pytest.mark.parametrize("name", ["QWEN2_5_VL", "INTERNVL2_5"])
def test_resolve_template_equals_jax(toks, name):
    """The chat families' prompts rendered through the checkpoint's own
    template by the reader equal the JAX package's through
    ``transformers``, and so do their ids."""
    mine, theirs = toks["qwen2"]
    got = templates.resolve_template(getattr(templates, name), mine)
    want = jtemplates.resolve_template(getattr(jtemplates, name), theirs)
    assert got.rendered_image == want.rendered_image
    assert got.rendered_text == want.rendered_text
    for one_word in (True, False):
        for fn in ("image_prompt", "text_prompt"):
            p, q = getattr(got, fn)(one_word), getattr(want, fn)(one_word)
            assert p == q
            assert mine.encode(got.expand_image(p, 3)) == \
                theirs.encode(want.expand_image(q, 3))
    # a string-wrapper family is returned as it is
    assert templates.resolve_template(templates.LLAMA3, toks["llama3"][0]) \
        is templates.LLAMA3


TEXT_ALPHABET = st.sampled_from(
    list("abcXYZ019") + [" ", "  ", "\n", "\t", "\r\n", "'s", "'T", "'ll",
                         "n't", "🙂", "🐶", "東", "京", "é", "é",
                         "ﬁ", "—", ".", ",", "!", "<image>", "<mask>",
                         "　", " ", "٣", "Ⅻ", "_"])


@settings(derandomize=True, max_examples=150, deadline=None)
@given(parts=st.lists(TEXT_ALPHABET, max_size=24),
       kind=st.sampled_from(KINDS), add=st.booleans())
def test_random_unicode_text_encodes_as_transformers(toks, parts, kind,
                                                     add):
    mine, theirs = toks[kind]
    text = "".join(parts)
    assert mine.encode(text, add) == theirs.encode(text, add)


def test_llama_tokenizer_class_rebuilds_its_post_processor(tmp_path):
    """A ``tokenizer_config.json`` naming ``LlamaTokenizerFast`` with
    ``add_eos_token``: transformers rebuilds the post-processor from the
    flags, and so does the reader."""
    from transformers import AutoTokenizer

    d = build_tokenizer("llama2_metaspace", tmp_path / "llama")
    cfg = json.loads((d / "tokenizer_config.json").read_text())
    cfg.update(tokenizer_class="LlamaTokenizerFast", add_bos_token=True,
               add_eos_token=True)
    (d / "tokenizer_config.json").write_text(json.dumps(cfg))
    mine = HFJsonTokenizer.from_dir(str(d))
    theirs = JAdapter(AutoTokenizer.from_pretrained(str(d)))
    for text in TEXTS[:20]:
        for add in (True, False):
            assert mine.encode(text, add) == theirs.encode(text, add)
    assert mine.encode("a dog")[-1] == mine.get_vocab()["</s>"]


def test_unsupported_layouts_raise(tmp_path, toks, monkeypatch):
    # a sentencepiece model is converted (test_torch_sentencepiece.py), but
    # one empty piece with proto2's default model type is a Unigram model;
    # a directory with neither file has nothing to read
    (tmp_path / "spm").mkdir()
    (tmp_path / "spm" / "tokenizer.model").write_bytes(b"\x0a\x00")
    with pytest.raises(NotImplementedError, match="Unigram"):
        HFJsonTokenizer.from_dir(str(tmp_path / "spm"))
    (tmp_path / "none").mkdir()
    with pytest.raises(FileNotFoundError, match="no tokenizer.json or "
                                                "tokenizer.model"):
        HFJsonTokenizer.from_dir(str(tmp_path / "none"))
    data = {"model": {"type": "Unigram", "vocab": []}}
    with pytest.raises(NotImplementedError, match="Unigram"):
        HFJsonTokenizer(data)
    for pre, match in (
            ({"type": "Digits", "individual_digits": True}, "Digits"),
            ({"type": "Split", "pattern": {"String": " "},
              "behavior": "Removed", "invert": False}, "Isolated only")):
        data = {"model": {"type": "BPE", "vocab": {}, "merges": []},
                "pre_tokenizer": pre}
        with pytest.raises(NotImplementedError, match=match):
            HFJsonTokenizer(data)
    # a chat template with no jinja2 raises; it never falls back silently
    mine = toks["qwen2"][0]
    monkeypatch.setitem(sys.modules, "jinja2", None)
    with pytest.raises(ImportError, match="jinja2"):
        mine.apply_chat_template([{"role": "user", "content": "x"}])
    with pytest.raises(ImportError, match="jinja2"):
        templates.resolve_template(templates.QWEN2_5_VL, mine)


def test_translate_regex_classes():
    import re

    rx = re.compile(translate_regex(r"[^\s\p{L}\p{N}]+|\p{N}|\s+|\S"))
    assert rx.findall("a1 ,!　x") == ["a", "1", " ", ",!", "　",
                                        "x"]
    # \s is Unicode White_Space (Oniguruma), not Python's str.isspace
    assert re.fullmatch(translate_regex(r"\s"), "\x1c") is None
    assert re.fullmatch(translate_regex(r"\s"), " ")

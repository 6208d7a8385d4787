"""PyTorch port: a checkpoint that ships only a sentencepiece
``tokenizer.model`` (``models/sentencepiece.py``) against ``transformers``
and the JAX package.

The test's own model is a Llama-2-shaped BPE ``tokenizer.model`` written
from a seed with the protobuf descriptor ``transformers`` bundles
(``tests/data/torch_port/make_fixtures.write_spm_model``: ``<unk>``,
control ``<s>`` / ``</s>``, 256 byte pieces, 3,000 merged pieces, the
characters last; ``byte_fallback``, ``add_dummy_prefix``, the identity
normalizer). ``transformers`` 4.57.6 cannot load it without
``sentencepiece``, which is not installed, so the oracle runs with a stand-in
``sentencepiece`` module that only reports the file's piece table
(``make_fixtures.StandInSentencePiece``); the merges, normalizer,
pre-tokenizer, post-processor and added tokens stay ``transformers``' own.

Exact: the parsed proto equals the descriptor's parse; the port's
``tokenizer.json`` dict equals ``AutoTokenizer.from_pretrained(d).
backend_tokenizer.to_str()`` for ``legacy`` true and false and the special
token layouts of the Llama configs; the ids of 200 seeded captions (leading,
repeated and trailing spaces, characters that take the byte fallback, the
specials' text) equal the JAX ``load_converted(d)[1]``'s; ``convert_hf_dir``
writes the ``tokenizer.json`` JAX's writes; the committed fixture and its
pinned ids are what the seed and ``transformers`` give.
"""

import importlib.util
import json
import os
import pickle
import shutil

import numpy as np
import pytest

from mllm_sparse_retrieval_tpu.models import convert as jconvert
from mllm_sparse_retrieval_tpu_torch.models import convert, sentencepiece
from mllm_sparse_retrieval_tpu_torch.models.hf_tokenizer import (
    HFJsonTokenizer)
from tests.torch_threads import one_torch_thread  # noqa: F401

transformers = pytest.importorskip("transformers")

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "torch_port")
_spec = importlib.util.spec_from_file_location(
    "torch_port_fixtures", os.path.join(FIX, "make_fixtures.py"))
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)


def _added(content, normalized, lstrip=False):
    return {"__type": "AddedToken", "content": content, "lstrip": lstrip,
            "normalized": normalized, "rstrip": False, "single_word": False}


# tokenizer_config.json (and special_tokens_map.json) layouts of Llama
# checkpoints: Vicuna's (legacy off, AddedToken dicts), the older string
# form (legacy by default), no prefix space either way, normalized specials
# re-flagged by added_tokens_decoder with a new token and an EOS template,
# and the legacy special_tokens_map route
CONFIGS = {
    "vicuna": (fixtures.VICUNA_CONFIG, None),
    "legacy_strings": ({"tokenizer_class": "LlamaTokenizer",
                        "bos_token": "<s>", "eos_token": "</s>",
                        "unk_token": "<unk>"}, None),
    "legacy_no_prefix": ({"tokenizer_class": "LlamaTokenizer",
                          "legacy": True, "add_prefix_space": False}, None),
    "no_prefix": ({"tokenizer_class": "LlamaTokenizer", "legacy": False,
                   "add_prefix_space": False}, None),
    "added_decoder": ({
        "tokenizer_class": "LlamaTokenizer", "legacy": True,
        "add_eos_token": True, "bos_token": _added("<s>", True),
        "eos_token": _added("</s>", True), "unk_token": _added("<unk>", True),
        "pad_token": "<pad>",
        "added_tokens_decoder": {
            "0": dict(_added("<unk>", True), special=True),
            "1": dict(_added("<s>", False), special=True),
            "3330": dict(_added("<image>", False, lstrip=True),
                         special=False)},
        "additional_special_tokens": ["<extra>", "<s>"]}, None),
    "special_tokens_map": ({"tokenizer_class": "LlamaTokenizer",
                            "legacy": False, "pad_token": None},
                           {"bos_token": dict(_added("<s>", True)),
                            "pad_token": "<unk>",
                            "additional_special_tokens": ["<x1>"]}),
}


@pytest.fixture
def oracle(monkeypatch):
    """``transformers`` able to convert a sentencepiece model here."""
    for target, name, value in fixtures.stand_in_patches():
        if isinstance(target, dict):
            monkeypatch.setitem(target, name, value)
        else:
            monkeypatch.setattr(target, name, value)
    from transformers import AutoTokenizer
    return AutoTokenizer


def _spm_dir(path, config, smap=None, seed=0):
    os.makedirs(path, exist_ok=True)
    fixtures.write_spm_model(os.path.join(path, "tokenizer.model"), seed)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f)
    if smap is not None:
        with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
            json.dump(smap, f)
    return str(path)


def _captions(seed, n=200):
    """Seeded captions: the fixture's words, with leading, repeated and
    trailing spaces, characters the model has only as bytes, and the
    specials' text."""
    rng = np.random.default_rng(seed)
    extra = ["Ωmega", "½", "🙂", "naïve", "Crème", "  ", "<s>", "</s>",
             "<unk>", "<image>", "\t", "ü", "東京"]
    out = []
    for i in range(n):
        words = list(rng.choice(fixtures.WORDS, int(rng.integers(3, 12))))
        for _ in range(int(rng.integers(0, 3))):
            words.insert(int(rng.integers(0, len(words) + 1)),
                         extra[int(rng.integers(len(extra)))])
        text = " ".join(words)
        if i % 5 == 0:
            text = " " * int(rng.integers(1, 3)) + text
        if i % 7 == 0:
            text += " "
        out.append(text)
    return out


def test_reader_parses_the_model_as_protobuf_does(tmp_path):
    from transformers.utils import sentencepiece_model_pb2_new as pb

    path = str(tmp_path / "tokenizer.model")
    fixtures.write_spm_model(path, seed=3, n_merges=500)
    with open(path, "rb") as f:
        data = f.read()
    want = pb.ModelProto.FromString(data)
    got = sentencepiece.read_model(data)
    assert got.pieces == [(p.piece, p.score, p.type) for p in want.pieces]
    ts, ns = want.trainer_spec, want.normalizer_spec
    assert (got.model_type, got.byte_fallback, got.unk_id, got.bos_id,
            got.eos_id, got.pad_id, got.unk_piece) == (
        ts.model_type, ts.byte_fallback, ts.unk_id, ts.bos_id, ts.eos_id,
        ts.pad_id, ts.unk_piece) == (2, True, 0, 1, 2, -1, "<unk>")
    assert (got.normalizer_name, got.add_dummy_prefix,
            got.remove_extra_whitespaces) == (
        ns.name, ns.add_dummy_prefix, ns.remove_extra_whitespaces) == (
        "identity", True, False)
    # fields the file leaves out take proto2's defaults
    empty = sentencepiece.read_model(b"")
    assert (empty.model_type, empty.pad_id, empty.add_dummy_prefix) == (
        pb.ModelProto().trainer_spec.model_type, -1, True)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tokenizer_json_equals_transformers(tmp_path, oracle, name):
    config, smap = CONFIGS[name]
    d = _spm_dir(tmp_path / name, config, smap)
    want = json.loads(oracle.from_pretrained(d).backend_tokenizer.to_str())
    got = sentencepiece.llama_tokenizer_json(
        sentencepiece.read_model_file(os.path.join(d, "tokenizer.model")),
        config, smap)
    assert got == want
    assert len(want["model"]["merges"]) > 3000
    # the reader reads the directory through the same dict
    assert HFJsonTokenizer.from_dir(d).get_vocab() == \
        oracle.from_pretrained(d).get_vocab()


@pytest.mark.parametrize("name", ["vicuna", "legacy_strings"])
def test_ids_equal_the_jax_load_converted(tmp_path, oracle, name):
    config, smap = CONFIGS[name]
    d = _spm_dir(tmp_path / "ckpt", config, smap)
    with open(os.path.join(d, "params.pkl"), "wb") as f:
        pickle.dump({"w": np.zeros((2,), np.float32)}, f)
    _, mine, _ = convert.load_converted(d, device="cpu")
    _, theirs, _ = jconvert.load_converted(d, None)
    assert theirs is not None and mine.vocab_size == theirs.vocab_size
    assert mine.pad_id == theirs.pad_id
    texts = _captions(1)
    assert any(t.startswith(" ") for t in texts) and any(
        "🙂" in t for t in texts) and any("</s>" in t for t in texts)
    for text in texts:
        for add in (True, False):
            assert mine.encode(text, add) == theirs.encode(text, add), text
    # the byte fallback is reached
    assert mine.get_vocab()["<0xF0>"] in mine.encode("🙂", False)


def test_convert_hf_dir_writes_the_tokenizer_json_jax_writes(tmp_path,
                                                              oracle):
    """A tokenizer.model-only LLaVA directory: the port's converter writes
    ``tokenizer.json`` beside the copied files; its dict equals the one
    JAX's ``save_pretrained`` writes, and both converted directories load
    to the same ids. A directory without tokenizer files loads no
    tokenizer, as in JAX."""
    from tests.test_torch_convert import _hf_model

    hf = tmp_path / "hf"
    _hf_model("llava", 2, False).save_pretrained(str(hf))
    _spm_dir(hf, fixtures.VICUNA_CONFIG)
    convert.convert_hf_dir(str(hf), str(tmp_path / "port"))
    jconvert.convert_hf_dir(str(hf), str(tmp_path / "jax"))
    with open(tmp_path / "port" / "tokenizer.json") as f:
        mine = json.load(f)
    with open(tmp_path / "jax" / "tokenizer.json") as f:
        theirs = json.load(f)
    assert mine == theirs
    assert (tmp_path / "port" / "tokenizer.model").exists()
    _, tok, _ = convert.load_converted(str(tmp_path / "port"), device="cpu")
    _, jtok, _ = jconvert.load_converted(str(tmp_path / "jax"), None)
    for text in _captions(2, 40):
        assert tok.encode(text) == jtok.encode(text)
    bare = tmp_path / "bare"
    shutil.copytree(tmp_path / "port", bare)
    for name in ("tokenizer.json", "tokenizer.model",
                 "tokenizer_config.json"):
        os.remove(bare / name)
    assert convert.load_converted(str(bare), device="cpu")[1] is None
    assert jconvert.load_converted(str(bare), None)[1] is None


# added_tokens.json beside the committed llama2_spm/ (3,330 pieces): new
# tokens after the vocab, given out of id order, one already a piece; a
# special_tokens_map.json that names two of them special (pad and an
# additional special token); and a config whose added_tokens_decoder makes
# from_pretrained skip the file
ADDED = {
    "plain": ({"<image>": 3331, "<x>": 3330, "▁the": 301}, None, None),
    "in_special_map": ({"<pad>": 3330, "<image>": 3331, "<x>": 3332},
                       {"pad_token": "<pad>",
                        "additional_special_tokens": ["<image>"]}, None),
    "config_decoder": ({"<image>": 3330}, None, {
        "3330": dict(_added("<y>", False), special=True)}),
}


@pytest.mark.parametrize("name", list(ADDED))
def test_added_tokens_json_beside_a_tokenizer_model(tmp_path, oracle,
                                                    name):
    added, smap, decoder = ADDED[name]
    d = tmp_path / "spm"
    shutil.copytree(os.path.join(FIX, "llama2_spm"), d)
    with open(d / "added_tokens.json", "w") as f:
        json.dump(added, f)
    if smap is not None:
        with open(d / "special_tokens_map.json", "w") as f:
            json.dump(smap, f)
    if decoder is not None:
        with open(d / "tokenizer_config.json", "w") as f:
            json.dump(dict(fixtures.VICUNA_CONFIG,
                           added_tokens_decoder=decoder), f)
    hf = oracle.from_pretrained(str(d))
    mine = HFJsonTokenizer.from_dir(str(d))
    assert json.loads(hf.backend_tokenizer.to_str())["added_tokens"] == \
        _added_tokens_of(str(d))
    assert mine.get_vocab() == hf.get_vocab()
    assert mine.pad_id == (hf.pad_token_id or 0)
    rng = np.random.default_rng(7)
    contents = list(added) + ["<y>"]
    texts = _captions(2, 100)
    texts += [f"{a} {c}{b}" for a, b, c in zip(
        texts, texts[1:], rng.choice(contents, len(texts) - 1))]
    for text in texts:
        for add in (True, False):
            assert mine.encode(text, add) == hf.encode(
                text, add_special_tokens=add), text


def _added_tokens_of(d):
    from mllm_sparse_retrieval_tpu_torch.models.hf_tokenizer import (
        _read_json, tokenizer_json_of_dir)

    return tokenizer_json_of_dir(
        d, _read_json(os.path.join(d, "tokenizer_config.json")),
        _read_json(os.path.join(d, "special_tokens_map.json")))[
            "added_tokens"]


def test_unigram_model_raises(tmp_path):
    path = str(tmp_path / "tokenizer.model")
    fixtures.write_spm_model(path, n_merges=50, model_type=1)
    with pytest.raises(NotImplementedError, match="Unigram"):
        sentencepiece.llama_tokenizer_json(
            sentencepiece.read_model_file(path), fixtures.VICUNA_CONFIG)


def test_committed_fixture_is_the_seeded_model_and_its_pinned_ids(
        tmp_path, oracle):
    """``chip_smoke.py`` reads ``llama2_spm/`` and holds the reader to
    ``spm_ids.json`` on the card, which has no ``transformers``."""
    committed = os.path.join(FIX, "llama2_spm")
    fixtures.write_spm_model(str(tmp_path / "tokenizer.model"))
    with open(os.path.join(committed, "tokenizer.model"), "rb") as f:
        assert f.read() == (tmp_path / "tokenizer.model").read_bytes()
    with open(os.path.join(committed, "tokenizer_config.json")) as f:
        assert json.load(f) == fixtures.VICUNA_CONFIG
    with open(os.path.join(FIX, "spm_ids.json")) as f:
        pinned = json.load(f)
    hf = oracle.from_pretrained(committed)
    mine = HFJsonTokenizer.from_dir(committed)
    assert pinned["vocab_size"] == len(hf) == mine.vocab_size
    assert [t for t, _, _ in pinned["texts"]] == fixtures.spm_texts()
    for text, with_special, without in pinned["texts"]:
        assert hf.encode(text) == with_special == mine.encode(text)
        assert hf.encode(text, add_special_tokens=False) == without == \
            mine.encode(text, False)


_BLOCKED_READ = """
import json, sys
for name in ('jax', 'jaxlib', 'mllm_sparse_retrieval_tpu', 'transformers',
             'tokenizers', 'google', 'sentencepiece', 'regex'):
    sys.modules[name] = None          # any import of these now fails
from mllm_sparse_retrieval_tpu_torch.models.hf_tokenizer import (
    HFJsonTokenizer)
tok = HFJsonTokenizer.from_dir(sys.argv[1])
with open(sys.argv[2]) as f:
    pinned = json.load(f)
print(all(tok.encode(t) == a and tok.encode(t, False) == b
          for t, a, b in pinned["texts"]), tok.vocab_size)
"""


def test_reader_needs_no_transformers_protobuf_or_sentencepiece():
    """The card machine has none of them: the committed fixture reads to
    its pinned ids with each blocked."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_READ, os.path.join(FIX, "llama2_spm"),
         os.path.join(FIX, "spm_ids.json")], cwd=repo, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["True", "3330"]

"""What the tests of the port's tools share with their JAX counterparts:
a tool of the JAX repository loaded from its file (the JAX compile cache
off), call recording, the JAX tiny model carried into the port, and
flickr-layout CSVs written from a seeded Karpathy JSON."""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np

from mllm_sparse_retrieval_tpu_torch.configs import ModelConfig, ModelFamily
from mllm_sparse_retrieval_tpu_torch.data.prep import (
    karpathy_json_to_csvs, sample_few_shot_csv)
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import (
    from_jax_params)
from mllm_sparse_retrieval_tpu_torch.models.registry import get_family_spec
from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
    WordPieceLiteTokenizer)

REPO = Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-5, rtol=1e-5)
TINY = dict(tiny_vocab_size=2048, tiny_hidden_size=128)   # the tools' own
WORDS = ["dog", "cat", "red", "bus", "man", "kite", "boat", "lake", "snow",
         "child", "bird", "wire", "grass", "city", "tree", "ball", "people",
         "ride", "bikes", "play", "holds", "near", "blue", "green", "house"]
N_TEST, N_TRAIN, FEW_SHOT, CAPS = 8, 14, 12, 5


def write_karpathy(root, seed, words, n_test=N_TEST, n_train=N_TRAIN,
                   few_shot=FEW_SHOT):
    """``root/flickr``'s test and train CSVs and the ``few_shot`` sample
    of the train split, from a seeded Karpathy JSON."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    images, sent = [], 0
    for i in range(n_train + n_test):
        images.append({
            "imgid": 500 + i, "filename": f"{500 + i}.jpg",
            "split": "train" if i < n_train else "test",
            "sentences": [{"raw": " ".join(rng.choice(
                words, int(rng.integers(4, 9)))), "sentid": sent + j}
                for j in range(CAPS)]})
        sent += CAPS
    (root / "dataset.json").write_text(json.dumps({"images": images}))
    out = karpathy_json_to_csvs(str(root / "dataset.json"),
                                str(root / "flickr"), "flickr")
    sample_few_shot_csv(out["train"],
                        str(root / "flickr" / f"flickr_train_{few_shot}.csv"),
                        num_images=few_shot, seed=0)
    return root


def jax_tool(name, monkeypatch, folder="tools"):
    """``<folder>/<name>.py`` of the JAX repository as a module, the JAX
    compile cache off."""
    from mllm_sparse_retrieval_tpu.cli import common as jcommon

    monkeypatch.setattr(jcommon, "enable_compilation_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f"jax_{folder}_{name}", REPO / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recording(monkeypatch, owner, name):
    """Wrap ``owner.name`` to record ``(args, kwargs, result)`` per call."""
    calls, real = [], getattr(owner, name)

    def wrapper(*a, **k):
        out = real(*a, **k)
        calls.append((a, k, out))
        return out

    monkeypatch.setattr(owner, name, wrapper)
    return calls


def carried(build_call):
    """The port's tiny model of a recorded JAX ``build_model`` call: the
    same weights, the tokenizer of the same captions, at the recorded
    config's tiny widths."""
    a, kw, (jparams, _, jtok, _) = build_call
    jcfg = a[0] if a else kw.get("model_cfg")
    tiny = {k: getattr(jcfg, k, TINY[k]) for k in TINY}
    tok = WordPieceLiteTokenizer.from_corpus_captions(
        kw["captions"], vocab_size=tiny["tiny_vocab_size"])
    assert tok.get_vocab() == jtok.get_vocab()
    spec = get_family_spec(ModelFamily.TINY_DEBUG,
                           ModelConfig(dtype="float32", **tiny))
    return (from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                            device="cpu"), spec.arch, tok, spec.template)

"""PyTorch port: ``cli.prepare_data`` (with ``data/prep.py``) and
``cli.train`` against the JAX package's CLIs on the same files. A seeded
Karpathy ``dataset.json`` is split, sampled and checked by both
``prepare_data`` CLIs; then both ``train`` CLIs train on the port's
few-shot CSV with ``--device cpu`` on ``tiny_debug`` and
``tiny_qwen_debug``. The port's CLI draws its own tiny model and adapters;
both are replaced by the JAX CLI's (``cli.train.build_model`` patched to
carry the JAX weights across with ``from_jax_params``,
``models.lora.init_lora`` to carry the JAX draw with ``from_jax_lora``),
so both sides train one model from one start, at ``--lora-dropout 0``.

Tolerances: CSVs and printed lines byte-equal; ``lora.pkl`` and the merged
``params.pkl`` after four Adam steps within ``atol=rtol=1e-4`` (f32 on
the CPU; ``test_torch_train.py``'s STEP_TOL); an adapter file loaded by
the other package equal to the tree that wrote it.
"""

import json
import pickle

import jax
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.cli import prepare_data as jcli_prep
from mllm_sparse_retrieval_tpu.cli import train as jcli_train
from mllm_sparse_retrieval_tpu.models import lora as jlora
from mllm_sparse_retrieval_tpu_torch.cli import prepare_data as cli_prep
from mllm_sparse_retrieval_tpu_torch.cli import train as cli_train
from mllm_sparse_retrieval_tpu_torch.data import prep
from mllm_sparse_retrieval_tpu_torch.models import lora
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import (
    from_jax_lora, from_jax_params)

STEP_TOL = dict(atol=1e-4, rtol=1e-4)
WORDS = ["dog", "cat", "red", "bus", "man", "kite", "boat", "lake", "snow",
         "child", "bird", "wire", "grass", "city", "tree", "ball"]


def _karpathy(path, seed=5, n=24):
    """A Karpathy-shaped dataset.json: train, restval, val and test images
    with 4-6 captions each (a comma in some, so the CSV quotes them)."""
    rng = np.random.default_rng(seed)
    splits = ["train", "restval", "train", "val", "test", "train"]
    images, sent = [], 0
    for i in range(n):
        sentences = []
        for _ in range(int(rng.integers(4, 7))):
            words = rng.choice(WORDS, size=int(rng.integers(3, 7)))
            raw = "a " + " ".join(words)
            if rng.random() < 0.2:
                raw = raw.replace(" ", ", ", 1)
            sentences.append({"raw": raw, "sentid": sent})
            sent += 1
        images.append({"imgid": i, "filename": f"{1000 + i}.jpg",
                       "filepath": "val2014", "split": splits[i % 6],
                       "sentences": sentences})
    path.write_text(json.dumps({"images": images}))
    return path


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """The port's split and few-shot CSVs (8 training images)."""
    root = tmp_path_factory.mktemp("prep")
    js = _karpathy(root / "dataset.json")
    cli_prep.main(["split", "--json", str(js), "--out-dir",
                   str(root / "port" / "flickr"), "--dataset", "flickr"])
    cli_prep.main(["few-shot", "--train-csv",
                   str(root / "port" / "flickr" / "flickr_train.csv"),
                   "--out-csv",
                   str(root / "port" / "flickr" / "flickr_train_8.csv"),
                   "--num-images", "8"])
    return root


@pytest.mark.parametrize("dataset", ["flickr", "coco"])
def test_prepare_data_cli_matches_jax(data_root, tmp_path, capsys, dataset):
    js = data_root / "dataset.json"
    outs = {}
    for name, cli in (("port", cli_prep), ("jax", jcli_prep)):
        out = tmp_path / name
        cli.main(["split", "--json", str(js), "--out-dir", str(out),
                  "--dataset", dataset])
        cli.main(["few-shot", "--train-csv",
                  str(out / f"{dataset}_train.csv"), "--out-csv",
                  str(out / f"{dataset}_train_5.csv"), "--num-images", "5",
                  "--seed", "3"])
        cli.main(["check", "--csv", str(out / f"{dataset}_test.csv")])
        outs[name] = (out, capsys.readouterr().out.replace(str(out), "OUT"))
    (port, port_out), (jax_dir, jax_out) = outs["port"], outs["jax"]
    assert port_out == jax_out
    files = sorted(p.name for p in port.iterdir())
    assert files == sorted(p.name for p in jax_dir.iterdir())
    assert len(files) == 4
    for f in files:
        assert (port / f).read_bytes() == (jax_dir / f).read_bytes(), f
    hist = prep.check_captions_per_image(str(port / f"{dataset}_train.csv"))
    assert sum(hist.values()) == 16 and set(hist) <= {4, 5, 6}


def test_prep_refuses_an_unknown_dataset(tmp_path):
    with pytest.raises(ValueError, match="coco or flickr"):
        prep.karpathy_json_to_csvs(str(tmp_path / "x.json"), str(tmp_path),
                                   "nocaps")


def _args(data_root, family, out, *extra):
    return ["--dataset", "flickr", "--data-root",
            str(data_root / "port"), "--family", family, "--dtype",
            "float32", "--few-shot-sum", "8", "--batch-size", "4",
            "--num-epochs", "2", "--learning-rate", "3e-3",
            "--lora-rank", "4", "--lora-alpha", "8", "--lora-dropout", "0",
            "--log-every", "0", "--output-dir", str(out), *extra]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **STEP_TOL)


@pytest.mark.parametrize("family,extra", [
    ("tiny_debug", ("--merge", "--checkpoint-every", "2")),
    ("tiny_qwen_debug", ()),
])
def test_train_cli_matches_the_jax_cli(data_root, tmp_path, capsys,
                                       monkeypatch, family, extra):
    built = {}
    real_j = jcli_train.build_model

    def j_build(cfg, captions=None, seed=0):
        built["jax"] = real_j(cfg, captions, seed)
        return built["jax"]

    monkeypatch.setattr(jcli_train, "build_model", j_build)
    jcli_train.main(_args(data_root, family, tmp_path / "jax", *extra))
    jparams, jarch = built["jax"][0], built["jax"][1]

    real = cli_train.build_model

    def build(cfg, captions=None, seed=0, device="cuda"):
        _, arch, tok, tmpl = real(cfg, captions, seed, device)
        return from_jax_params(_np(jparams), device), arch, tok, tmpl

    def init_lora(gen, params, arch, rank, alpha, train_vision,
                  train_projector, device):
        return from_jax_lora(_np(jlora.init_lora(
            jax.random.PRNGKey(0), jparams, jarch, rank=rank, alpha=alpha,
            train_vision=train_vision, train_projector=train_projector)),
            device)

    monkeypatch.setattr(cli_train, "build_model", build)
    monkeypatch.setattr(cli_train.lora_lib, "init_lora", init_lora)
    cli_train.main(_args(data_root, family, tmp_path / "port", "--device",
                         "cpu", *extra))
    printed = capsys.readouterr().out.split()
    assert printed == [str(tmp_path / "jax" / "lora.pkl"),
                       str(tmp_path / "port" / "lora.pkl")]
    with open(tmp_path / "port" / "lora.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jax" / "lora.pkl", "rb") as f:
        want = _np(pickle.load(f))
    _close(got, want)
    start = _np(jlora.init_lora(jax.random.PRNGKey(0), jparams, jarch,
                                rank=4, alpha=8.0))
    assert max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(got),
        jax.tree_util.tree_leaves(start))) > 1e-3
    if "--merge" in extra:
        with open(tmp_path / "port" / "params.pkl", "rb") as f:
            merged = pickle.load(f)
        with open(tmp_path / "jax" / "params.pkl", "rb") as f:
            jmerged = _np(pickle.load(f))
        _close(merged, {k: jmerged[k] for k in merged})
        assert (tmp_path / "port" / "ckpts" / "latest").read_text() == "4"
        assert (tmp_path / "port" / "ckpts" / "step_2" /
                "checkpoint.pt").exists()


def test_adapter_files_load_in_both_packages(tmp_path):
    gen = torch.Generator().manual_seed(3)
    params = {"text": {"blocks": [
        {n: {"w": torch.randn(8, 8, generator=gen)} for n in
         ("q", "k", "v", "o", "gate", "up", "down")} for _ in range(2)]}}
    ad = lora.init_lora(gen, params, None, rank=2, device="cpu")
    for blk in ad["text"]["blocks"]:
        blk["q"]["b"] = torch.randn(blk["q"]["b"].shape, generator=gen)
    lora.save_lora(ad, str(tmp_path / "port.pkl"))
    theirs = jlora.load_lora(str(tmp_path / "port.pkl"))
    for a, b in zip(jax.tree_util.tree_leaves(ad),
                    jax.tree_util.tree_leaves(theirs)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jlora.save_lora(theirs, str(tmp_path / "jax.pkl"))
    back = lora.load_lora(str(tmp_path / "jax.pkl"), device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(ad),
                    jax.tree_util.tree_leaves(back)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flag,match", [
    (("--mesh",), "Queue 1 #9"),
    (("--load-kbit", "4"), "Queue 1 #1"),
])
def test_train_cli_refuses_what_is_not_ported(data_root, tmp_path, flag,
                                              match):
    args = cli_train.build_parser().parse_args(
        _args(data_root, "tiny_debug", tmp_path, "--device", "cpu", *flag))
    with pytest.raises(NotImplementedError, match=match):
        cli_train.run(args)
    assert not (tmp_path / "lora.pkl").exists()

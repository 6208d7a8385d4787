"""PyTorch port: the offline CLIs, ``cli.encode`` -> ``cli.index`` ->
``cli.search``, with ``--device cpu --family tiny_debug`` on a flickr CSV
this file writes, against the JAX package's library calls on the same
inputs (``encode_examples`` + ``write_artifacts``,
``ImpactIndex.from_jsonl``, ``DenseFlatIndex.load``, ``run_search``; never
its CLIs, which write a compile cache into the tree). The port's CLI draws
its own tiny model; only its weights are replaced by the JAX package's
(``cli.common.build_model`` patched to carry them across with
``from_jax_params``), so both sides run one model.

Tolerances: the sparse jsonl, the saved index (``terms.json`` and every
array of ``index.npz``), the pickles' ids, each query's doc set in the
TREC runs and the printed recall / MRR summary are exact (with this seed no
target sits in a tie at a cutoff, so recall does not depend on tie order);
pickled dense vectors agree to f32 ``atol=rtol=1e-5``.
"""

import json
import pickle

import jax
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.configs import ModelConfig as JModelConfig
from mllm_sparse_retrieval_tpu.configs import ModelFamily as JFamily
from mllm_sparse_retrieval_tpu.configs import SearchConfig as JSearchConfig
from mllm_sparse_retrieval_tpu.configs import SparseConfig as JSparseConfig
from mllm_sparse_retrieval_tpu.data.karpathy import CrossModalCorpus as JCorpus
from mllm_sparse_retrieval_tpu.index.dense import (
    DenseFlatIndex as JDenseFlatIndex)
from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpactIndex
from mllm_sparse_retrieval_tpu.models import build_model as j_build_model
from mllm_sparse_retrieval_tpu.pipelines import encode as jencode
from mllm_sparse_retrieval_tpu.search import fusion as jfusion
from mllm_sparse_retrieval_tpu.search.engine import run_search as j_run_search
from mllm_sparse_retrieval_tpu_torch.cli import common
from mllm_sparse_retrieval_tpu_torch.cli import encode as cli_encode
from mllm_sparse_retrieval_tpu_torch.cli import index as cli_index
from mllm_sparse_retrieval_tpu_torch.cli import search as cli_search
from mllm_sparse_retrieval_tpu_torch.configs import ModelConfig
from mllm_sparse_retrieval_tpu_torch.models import mllm
from mllm_sparse_retrieval_tpu_torch.models.convert import arch_to_manifest
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import from_jax_params

WORDS = ["dog", "cat", "red", "bus", "man", "kite", "boat", "lake", "snow",
         "child", "bird", "wire", "grass", "city", "tree", "ball"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(4)
    (root / "flickr").mkdir()
    lines = ["imgid,filename,caption,sentid"]
    for i in range(9):
        for c in range(2):
            cap = "a " + " ".join(rng.choice(WORDS, size=int(
                rng.integers(3, 7))))
            lines.append(f"{40 + i},{40 + i}.jpg,{cap},{100 + 2 * i + c}")
    (root / "flickr" / "flickr_test.csv").write_text("\n".join(lines) + "\n")
    return root


@pytest.fixture(scope="module")
def jax_model(data_root):
    corpus = JCorpus("flickr", "test", str(data_root))
    return j_build_model(
        JModelConfig(family=JFamily.TINY_DEBUG, dtype="float32"),
        captions=list(corpus.text_dict.values()))


@pytest.fixture
def jax_weights(monkeypatch, jax_model):
    """The CLI builds its own tiny model; its weights become the JAX
    package's."""
    real = common.build_model

    def build_model(model_cfg, captions=None, seed=0, device="cuda"):
        _, arch, tok, tmpl = real(model_cfg, captions, seed, device)
        params = from_jax_params(
            jax.tree_util.tree_map(np.asarray, jax_model[0]), device=device)
        return params, arch, tok, tmpl

    monkeypatch.setattr(common, "build_model", build_model)


def _common(data_root):
    return ["--dataset", "flickr", "--data-root", str(data_root),
            "--family", "tiny_debug", "--dtype", "float32", "--device",
            "cpu", "--batch-size", "4"]


def _leaf(base, kind):
    return base / "tiny_debug" / "flickr" / kind / "filter" / "0_no_manual_128"


@pytest.mark.parametrize("query_type,doc_type", [("text", "image"),
                                                 ("image", "text")])
def test_encode_index_search_cli_matches_jax_library(
        data_root, jax_model, jax_weights, tmp_path, capsys, query_type,
        doc_type):
    out = tmp_path / "port"
    cli_encode.main(_common(data_root) + [
        "--encode-type", doc_type, "--dense-output-dir", str(out / "dense"),
        "--sparse-output-dir", str(out / "sparse")])
    printed = capsys.readouterr().out.split()
    dense_dir, sparse_dir = _leaf(out / "dense", doc_type), \
        _leaf(out / "sparse", doc_type)
    assert printed == [str(dense_dir), str(sparse_dir)]
    for native in ([], ["--no-native"]):
        name = "idx" + "".join(native)
        cli_index.main(["--input", str(sparse_dir), "--index",
                        str(out / name), "--device", "cpu", "--hbm-warm"]
                       + native)
        assert capsys.readouterr().out.split() == [str(out / name)]
    search_args = _common(data_root) + [
        "--query-type", query_type, "--passage-reps", str(dense_dir),
        "--sparse-index", str(out / "idx"), "--depth", "20",
        "--metrics", "mrr", "--save-dir", str(out / "runs")]
    cli_search.main(search_args)
    summary = capsys.readouterr().out.strip()

    # the JAX package's library calls on the same inputs
    params, arch, tok, tmpl = jax_model
    corpus = JCorpus("flickr", "test", str(data_root))
    jdir = tmp_path / "jax"
    res = jencode.encode_examples(
        corpus.examples("full" if doc_type == "text" else "single"),
        params, arch, tok, tmpl, encode_type=doc_type,
        sparse_cfg=JSparseConfig(), batch_size=4)
    jencode.write_artifacts(res, str(jdir / "dense"), str(jdir / "sparse"))
    jindex = JImpactIndex.from_jsonl([str(jdir / "sparse" /
                                          "corpus_0.jsonl")],
                                     use_native=False)
    jindex.save(str(jdir / "idx"))
    jout = j_run_search(
        corpus.examples("full" if query_type == "text" else "single"),
        params, arch, tok, tmpl, query_type=query_type,
        sparse_cfg=JSparseConfig(), search_cfg=JSearchConfig(depth=20),
        dense_index=JDenseFlatIndex.load(str(jdir / "dense")),
        impact_index=JImpactIndex.load(str(jdir / "idx")), batch_size=4,
        metrics=["mrr"],
        get_target=lambda q: corpus.get_target(q, query_type))

    assert (sparse_dir / "corpus_0.jsonl").read_text() == \
        (jdir / "sparse" / "corpus_0.jsonl").read_text()
    mine = JDenseFlatIndex.load(str(dense_dir))
    assert mine.lookup == res.ids
    np.testing.assert_allclose(np.concatenate(mine._chunks), res.dense,
                               atol=1e-5, rtol=1e-5)
    for name in ("idx", "idx--no-native"):
        assert json.loads((out / name / "terms.json").read_text()) == \
            json.loads((jdir / "idx" / "terms.json").read_text())
        with np.load(out / name / "index.npz") as a, \
                np.load(jdir / "idx" / "index.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key])
    assert summary == jout.summary()
    assert summary.count("recall: r@1 ") == 3 and "mrr@1" in summary
    # depth 20 keeps every scored doc of the 9 or 18: per query, the same
    # doc set (the rank order of equal scores is not part of the contract)
    for name in ("dense", "sparse", "fusion"):
        jfusion.write_trec_run(getattr(jout, f"{name}_run"),
                               str(jdir / f"{name}.trec"), name)
        docs = []
        for path in (out / "runs" / f"{name}.trec", jdir / f"{name}.trec"):
            per_q = {}
            for line in path.read_text().splitlines():
                q, _, d, _, _, tag = line.split()
                assert tag == name
                per_q.setdefault(q, set()).add(d)
            docs.append(per_q)
        assert docs[0] == docs[1] and docs[0]


def test_search_cli_takes_bf16_dense_and_writes_a_trace(
        data_root, jax_weights, tmp_path, capsys):
    out = tmp_path / "port"
    cli_encode.main(_common(data_root) + [
        "--encode-type", "image", "--dense-output-dir", str(out / "dense"),
        "--sparse-output-dir", str(out / "sparse")])
    capsys.readouterr()
    cli_search.main(_common(data_root) + [
        "--passage-reps", str(_leaf(out / "dense", "image")), "--depth",
        "5", "--dense-dtype", "bfloat16", "--limit", "6",
        "--profile-dir", str(out / "trace")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("dense recall: r@1 ")
    trace = json.loads((out / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("flags,match", [
    (["--fusion-mode", "device"], "needs both --passage-reps"),
    (["--eval-mode", "device", "--save-dir", "runs"],
     "never materializes runs"),
    (["--ann-rank", "16", "--dense-dtype", "int8"],
     "incompatible with --dense-dtype int8"),
    ([], "--passage-reps and/or --sparse-index"),
])
def test_search_cli_rejects_what_is_not_ported(data_root, capsys, flags,
                                               match):
    base = [] if not flags else ["--passage-reps", "x"]
    with pytest.raises(SystemExit) as e:
        cli_search.main(_common(data_root) + base + flags)
    assert e.value.code == 2
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--impact-wire", "compact48"],
    ["--dense-dtype", "int8"],
    ["--ann-rank", "8", "--ann-candidates", "12"],
])
def test_search_cli_tiers_and_wire_match_jax_library(
        data_root, jax_model, jax_weights, tmp_path, capsys, flags):
    """``--impact-wire compact48``, ``--dense-dtype int8`` and ``--ann-rank``
    (hybrid, host fusion): the printed recall summary equals the JAX
    package's ``run_search`` with the same tier and wire over the same
    artifacts."""
    import jax.numpy as jnp

    from mllm_sparse_retrieval_tpu.index.ann import DenseANNIndex as JANN

    out = tmp_path / "port"
    cli_encode.main(_common(data_root) + [
        "--encode-type", "image", "--dense-output-dir", str(out / "dense"),
        "--sparse-output-dir", str(out / "sparse")])
    capsys.readouterr()
    dense_dir = _leaf(out / "dense", "image")
    cli_index.main(["--input", str(_leaf(out / "sparse", "image")),
                    "--index", str(out / "idx"), "--device", "cpu"])
    capsys.readouterr()
    cli_search.main(_common(data_root) + [
        "--passage-reps", str(dense_dir), "--sparse-index",
        str(out / "idx"), "--depth", "20"] + flags)
    summary = capsys.readouterr().out.strip()

    params, arch, tok, tmpl = jax_model
    corpus = JCorpus("flickr", "test", str(data_root))
    dense = JDenseFlatIndex.load(
        str(dense_dir), dtype=jnp.int8 if "int8" in flags else jnp.float32)
    if "--ann-rank" in flags:
        dense = JANN.from_flat(dense, rank=8, candidates=12)
    jout = j_run_search(
        corpus.examples("full"), params, arch, tok, tmpl, query_type="text",
        sparse_cfg=JSparseConfig(), search_cfg=JSearchConfig(depth=20),
        dense_index=dense, impact_index=JImpactIndex.load(str(out / "idx")),
        batch_size=4, impact_wire="compact48" if "compact48" in flags
        else "i32", get_target=lambda q: corpus.get_target(q, "text"))
    assert summary == jout.summary()
    assert summary.count("recall: r@1 ") == 3


@pytest.mark.parametrize("eval_mode", ["host", "device"])
def test_search_cli_device_fusion_matches_jax_library(
        data_root, jax_model, jax_weights, tmp_path, capsys, eval_mode):
    """``--fusion-mode device`` (and ``--eval-mode device``): the printed
    fusion recall and MRR equal the JAX package's ``run_search`` on the
    device routes over the same artifacts."""
    out = tmp_path / "port"
    cli_encode.main(_common(data_root) + [
        "--encode-type", "image", "--dense-output-dir", str(out / "dense"),
        "--sparse-output-dir", str(out / "sparse")])
    capsys.readouterr()
    dense_dir, sparse_dir = _leaf(out / "dense", "image"), \
        _leaf(out / "sparse", "image")
    cli_index.main(["--input", str(sparse_dir), "--index", str(out / "idx"),
                    "--device", "cpu"])
    capsys.readouterr()
    cli_search.main(_common(data_root) + [
        "--passage-reps", str(dense_dir), "--sparse-index",
        str(out / "idx"), "--depth", "20", "--metrics", "mrr",
        "--fusion-mode", "device", "--eval-mode", eval_mode])
    summary = capsys.readouterr().out.strip()

    params, arch, tok, tmpl = jax_model
    corpus = JCorpus("flickr", "test", str(data_root))
    jout = j_run_search(
        corpus.examples("full"), params, arch, tok, tmpl, query_type="text",
        sparse_cfg=JSparseConfig(), search_cfg=JSearchConfig(depth=20),
        dense_index=JDenseFlatIndex.load(str(dense_dir)),
        impact_index=JImpactIndex.load(str(out / "idx")), batch_size=4,
        metrics=["mrr"], fusion_mode="device", eval_mode=eval_mode,
        get_target=lambda q: corpus.get_target(q, "text"))
    assert summary == jout.summary()
    assert summary.startswith("fusion recall: r@1 ") and "mrr@1" in summary


@pytest.mark.parametrize("flags,match", [
    (["--mesh"], "Queue 1 #9"),
    # a checkpoint that ships no tokenizer: the port cannot read one
    # without transformers' tokenizer files (#8b)
    (["--family", "llava_next_llama3", "--checkpoint-path", "CKPT"],
     "Queue 1 #8"),
])
def test_cli_refuses_mesh_and_checkpoints(data_root, tmp_path, flags, match):
    if "CKPT" in flags:
        ckpt = tmp_path / "ckpt"
        ckpt.mkdir()
        arch = common.build_model(ModelConfig(dtype="float32"),
                                  device="cpu")[1]
        gen = torch.Generator(device="cpu").manual_seed(0)
        host = jax.tree_util.tree_map(
            lambda t: t.numpy(), mllm.init_params(arch, gen, "cpu",
                                                  torch.float32))
        with open(ckpt / "params.pkl", "wb") as f:
            pickle.dump(host, f)
        (ckpt / "arch.json").write_text(json.dumps(arch_to_manifest(arch)))
        flags = [str(ckpt) if f == "CKPT" else f for f in flags]
    with pytest.raises(NotImplementedError, match=match):
        cli_encode.main(_common(data_root) + flags + [
            "--dense-output-dir", str(tmp_path / "d"),
            "--sparse-output-dir", str(tmp_path / "s")])


def test_dense_dtype_help_names_the_dtypes(capsys):
    with pytest.raises(SystemExit):
        cli_search.main(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "--device" in text
    assert "float32 (FAISS-flat parity) or bfloat16" in text
    assert "int8 (SQ8 scalar quantization" in text
    for flag in ("--impact-wire", "--ann-rank", "--ann-candidates"):
        assert flag in text

"""PyTorch port: the three runbooks of ``mllm_sparse_retrieval_tpu_torch/
tools/`` against the JAX package's ``tools/*.py`` (loaded from their files,
the JAX compile cache patched off), on flickr-layout CSVs written here from
a seeded Karpathy JSON with the port's ``data/prep.py`` (synthetic pixels:
the image files are absent), the tiny model each JAX tool builds carried
across with ``from_jax_params``.

Ties: the depth (the tools' default 1,000) is above both corpora, so no
document is cut and a run is compared whole, per query, as a set of (id,
score): sparse scores exactly, dense and fused ones within ``TOL``. Recall
is compared exactly. The markdown rows are equal but for the QPS column,
the index build column (seconds) and the hardware in the notes.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest

from mllm_sparse_retrieval_tpu.data import CrossModalCorpus as JCorpus
from mllm_sparse_retrieval_tpu_torch.configs import ModelConfig, ModelFamily
from mllm_sparse_retrieval_tpu_torch.models import build_model
from mllm_sparse_retrieval_tpu_torch.models import convert
from mllm_sparse_retrieval_tpu_torch.tools import (
    common, corpus_e2e, reproduce_recall, train_retrieve_e2e)
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_tool_helpers import (
    CAPS, FEW_SHOT, N_TEST, TOL, WORDS, carried, jax_tool, recording,
    write_karpathy)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_karpathy(tmp_path_factory.mktemp("tools_data"), 3, WORDS)


def run_rows(run):
    """qid -> {doc: score} of a ``make_run`` run or a fused run."""
    out = {}
    for qid in run:
        entry = run[qid]
        docs = entry["docs"] if "docs" in entry else entry
        out[qid] = {d: float(s) for d, s in docs.items()}
    return out


def assert_runs_equal(got, want, exact):
    got, want = run_rows(got), run_rows(want)
    assert list(got) == list(want)
    for qid in want:
        assert set(got[qid]) == set(want[qid]), qid
        for doc, score in want[qid].items():
            if exact:
                assert got[qid][doc] == score, (qid, doc)
            else:
                np.testing.assert_allclose(got[qid][doc], score, **TOL)


def assert_recall_equal(got, want):
    assert got.num_queries == want.num_queries
    assert got.recalls == want.recalls


# ---- reproduce_recall -------------------------------------------------------

def table_cells(path):
    lines = Path(path).read_text().splitlines()
    return [[c.strip() for c in ln.strip("|").split("|")] for ln in lines]


def assert_rows_equal(got_md, want_md, hw):
    got, want = table_cells(got_md), table_cells(want_md)
    assert len(got) == len(want) == 2 + 6
    assert got[:2] == want[:2]
    for g, w in zip(got[2:], want[2:]):
        assert g[:6] == w[:6]                 # config .. R@10
        float(g[6])                           # QPS
        assert re.fullmatch(r"dense \d+\.\ds \+ impact \d+\.\ds", g[7])
        assert g[8] == f"{hw}, search-only QPS (queries pre-encoded)"
        assert w[8].endswith(", search-only QPS (queries pre-encoded)")


def test_reproduce_recall_matches_the_jax_runbook(data, monkeypatch,
                                                  tmp_path):
    from mllm_sparse_retrieval_tpu import models as jmodels
    from mllm_sparse_retrieval_tpu.eval import recall as jrecall
    from mllm_sparse_retrieval_tpu_torch.eval import recall as precall

    argv = ["--data-root", str(data), "--family", "tiny_debug", "--dtype",
            "float32", "--batch-size", "4"]
    jmod = jax_tool("reproduce_recall", monkeypatch)
    builds = recording(monkeypatch, jmodels, "build_model")
    jruns = recording(monkeypatch, jrecall, "recall_at_k")
    want = jmod.main(argv + ["--out", str(tmp_path / "jax.md")])
    pruns = recording(monkeypatch, precall, "recall_at_k")
    got = reproduce_recall.main(
        argv + ["--device", "cpu", "--out", str(tmp_path / "port.md")],
        model=carried(builds[0]))

    assert list(got) == list(want) == ["t2i", "i2t"]
    for direction in want:
        assert list(got[direction]) == list(want[direction]) == [
            "dense", "sparse", "hybrid a=0.5"]
        for config, (rec, qps) in want[direction].items():
            assert_recall_equal(got[direction][config][0], rec)
            assert got[direction][config][1] > 0
    # the six runs in the order they were scored: t2i, then i2t
    assert len(pruns) == len(jruns) == 6
    for i, ((pa, _, _), (ja, _, _)) in enumerate(zip(pruns, jruns)):
        assert_runs_equal(pa[0], ja[0], exact=i % 3 == 1)
    assert_rows_equal(tmp_path / "port.md", tmp_path / "jax.md", "cpu")
    # captions and images both ranked whole (depth above each corpus)
    assert {len(d) for d in run_rows(pruns[0][0][0]).values()} == {N_TEST}
    assert {len(d) for d in run_rows(pruns[3][0][0]).values()} == {
        N_TEST * CAPS}


def test_reproduce_recall_from_a_checkpoint_path(tmp_path):
    """A tiny converted LLaVA-1.5 directory (``test_torch_convert``'s):
    ``--checkpoint-path`` gives the rows that ``model=`` gives on the tree
    ``build_model`` loads from it."""
    from tests.test_torch_convert import WORDS as CKPT_WORDS
    from tests.test_torch_convert import _hf_model, _save_tokenizer

    root = write_karpathy(tmp_path / "data", 5, CKPT_WORDS)
    hf, ckpt = tmp_path / "hf", tmp_path / "ckpt"
    _hf_model("llava", 2, False).save_pretrained(str(hf))
    _save_tokenizer(hf)
    convert.convert_hf_dir(str(hf), str(ckpt))
    argv = ["--data-root", str(root), "--family", "llava_1_5", "--dtype",
            "float32", "--batch-size", "4", "--device", "cpu"]
    by_path = reproduce_recall.main(argv + [
        "--checkpoint-path", str(ckpt), "--out", str(tmp_path / "a.md")])
    model = build_model(ModelConfig(family=ModelFamily.LLAVA_1_5,
                                    checkpoint_path=str(ckpt),
                                    dtype="float32"), device="cpu")
    given = reproduce_recall.main(argv + ["--out", str(tmp_path / "b.md")],
                                  model=model)
    for direction in by_path:
        for config, (rec, _) in by_path[direction].items():
            assert_recall_equal(given[direction][config][0], rec)
            assert rec.num_queries == (N_TEST * CAPS if direction == "t2i"
                                       else N_TEST)
    assert_rows_equal(tmp_path / "a.md", tmp_path / "b.md", "cpu")


def test_runbooks_refuse_cuda_without_a_card(data, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.checked_device("cuda")
    with pytest.raises(RuntimeError, match="--device cpu"):
        reproduce_recall.main(["--data-root", str(data)])
    assert common.hardware(common.checked_device("cpu")) == "cpu"


# ---- train_retrieve_e2e -----------------------------------------------------

TRAIN_ARGV = ["--few-shot", str(FEW_SHOT), "--limit-images", "8",
              "--epochs", "1", "--batch-size", "4", "--depth", "5"]


def test_train_retrieve_e2e_before_training_matches_jax(data, monkeypatch):
    from mllm_sparse_retrieval_tpu import models as jmodels

    argv = TRAIN_ARGV + ["--data-root", str(data), "--min-lift", "-1"]
    jmod = jax_tool("train_retrieve_e2e", monkeypatch)
    builds = recording(monkeypatch, jmodels, "build_model")
    jouts = recording(monkeypatch, jmod, "evaluate")
    assert jmod.main(argv) == 0
    pouts = recording(monkeypatch, train_retrieve_e2e, "evaluate")
    assert train_retrieve_e2e.main(argv + ["--device", "cpu"],
                                   model=carried(builds[0])) == 0
    assert len(pouts) == len(jouts) == 3     # before, after, all captions
    got, want = pouts[0][2], jouts[0][2]
    for leg in ("dense", "sparse", "fusion"):
        assert_recall_equal(getattr(got, f"{leg}_recall"),
                            getattr(want, f"{leg}_recall"))
    assert_runs_equal(got.sparse_run, want.sparse_run, exact=True)
    assert_runs_equal(got.dense_run, want.dense_run, exact=False)
    assert got.dense_recall.num_queries == 8
    # the merged model serves all five captions of each image
    assert pouts[2][2].dense_recall.num_queries == 8 * CAPS


def test_train_retrieve_e2e_exits_1_below_its_gate(data, capsys):
    argv = TRAIN_ARGV + ["--data-root", str(data), "--device", "cpu",
                         "--min-lift", "1.01"]     # above any lift
    assert train_retrieve_e2e.main(argv) == 1
    assert "FAIL: recall@1 lift" in capsys.readouterr().out


# ---- corpus_e2e ---------------------------------------------------------------

CORPUS_ARGV = ["--limit-captions", str(N_TEST * CAPS), "--batch-size", "8"]


def test_corpus_e2e_matches_jax(data, monkeypatch):
    jmod = jax_tool("corpus_e2e", monkeypatch)
    monkeypatch.setattr(jmod, "CrossModalCorpus",
                        lambda name, split, _root: JCorpus(name, split,
                                                           str(data)))
    builds = recording(monkeypatch, jmod, "build_model")
    jouts = recording(monkeypatch, jmod, "run_search")
    monkeypatch.setattr(sys, "argv", ["corpus_e2e"] + CORPUS_ARGV)
    jmod.main()
    pouts = recording(monkeypatch, corpus_e2e, "run_search")
    assert corpus_e2e.main(CORPUS_ARGV + ["--data-root", str(data),
                                          "--device", "cpu"],
                           model=carried(builds[0])) == 0
    assert len(pouts) == len(jouts) == 2     # i2t, then self-retrieval
    for (_, _, got), (_, _, want) in zip(pouts, jouts):
        for leg in ("dense", "sparse", "fusion"):
            g, w = getattr(got, f"{leg}_recall"), getattr(want,
                                                         f"{leg}_recall")
            assert (g is None) == (w is None)
            if w is not None:
                assert_recall_equal(g, w)
        assert_runs_equal(got.dense_run, want.dense_run, exact=False)
        assert_runs_equal(got.sparse_run, want.sparse_run, exact=True)
    assert pouts[1][2].dense_recall[1] == 1.0


def test_corpus_e2e_exits_nonzero_on_an_id_mismatch(data, monkeypatch,
                                                   capsys):
    """Two seeded caption ids swapped after encoding: the rows no longer
    carry their captions' ids."""
    rng = np.random.default_rng(0)
    real = corpus_e2e.encode_examples

    def swapped(*a, **k):
        out = real(*a, **k)
        i, j = rng.choice(len(out.ids), 2, replace=False)
        out.ids[i], out.ids[j] = out.ids[j], out.ids[i]
        return out

    monkeypatch.setattr(corpus_e2e, "encode_examples", swapped)
    assert corpus_e2e.main(CORPUS_ARGV + ["--data-root", str(data),
                                          "--device", "cpu"]) == 1
    assert "FAIL: the encoded ids" in capsys.readouterr().out

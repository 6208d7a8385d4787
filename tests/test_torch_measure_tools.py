"""PyTorch port: the measuring tools of ``mllm_sparse_retrieval_tpu_torch/
tools/`` and ``examples/smoke.py`` against the JAX repository's
``tools/*.py`` and ``examples/smoke.py`` (loaded from their files, the JAX
compile cache patched off), at small sizes, ``--device cpu``, the same
seed through both.

What is compared:
- the draws: the corpus and query arrays, exactly;
- served rows (``serve_loadtest``) at a depth at or above the corpus, so
  no document is cut: as sets of (id, score), impact scores exactly,
  dense and fused ones within ``TOL``; the JSON keys for every mode and
  transport and both live designs (whose rows depend on the writers'
  timing);
- streamed and searched rows (``latency_profile``, ``engine_ab``,
  ``live_ab``): impact rows equal up to documents tied at a depth cut
  (equal sorted scores, equal sets above the cut score), dense rows
  within ``TOL``;
- fused scores (``hybrid_ab``) within ``TOL`` of the port's host fuse and
  of JAX's device-fused run; recall (``eval_ab``, ``ann_ab``) exactly;
- ``dense_ab``: f32 top-k ids equal and scores within ``TOL``, int8
  scores exactly (an exact int32 product dequantized in one order), and
  the bf16 overlap with f32 within ``BF16_OVERLAP_TOL`` of JAX's;
- ``mxu_probe``: the f32 full leg's top-k against JAX's ``mips_topk``;
- ``scaling_report``: bytes per device row by row against the JAX tool's
  ``_bytes_per_device`` on the JAX trees at 8 devices; the port's census
  of transfers pinned (it counts calls as they run, which XLA's HLO op
  counts are not);
- ``cache_probe``: the library names of ``ops/cuda_build.py`` and hits;
- ``examples/smoke``: the cosine matrix within ``TOL``, top terms equal.
"""

import inspect
import json
import sys

import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.data import CrossModalCorpus as JCorpus
from mllm_sparse_retrieval_tpu_torch.examples import smoke
from mllm_sparse_retrieval_tpu_torch.ops import cuda_build
from mllm_sparse_retrieval_tpu_torch.tools import (
    ann_ab, cache_probe, common, dense_ab, engine_ab, eval_ab, hybrid_ab,
    latency_profile, live_ab, mxu_probe, scaling_report, serve_loadtest)
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_tool_helpers import (
    TOL, WORDS, carried, jax_tool, recording, write_karpathy)

CPU = ["--device", "cpu"]
BF16_OVERLAP_TOL = 0.02


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_karpathy(tmp_path_factory.mktemp("measure_data"), 4, WORDS)


def run_jax(mod, argv, monkeypatch):
    """A JAX tool's ``main()``, which reads ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", [mod.__name__] + list(argv))
    return mod.main()


def recording_stream(monkeypatch, owner, name):
    """Wrap the generator method ``owner.name``: one list of its yielded
    items per call."""
    calls, real = [], getattr(owner, name)

    def wrapper(*a, **k):
        items = []
        calls.append(items)
        for item in real(*a, **k):
            items.append(item)
            yield item

    monkeypatch.setattr(owner, name, wrapper)
    return calls


def same_up_to_ties(got, want):
    """Rows of ``(scores, ids)`` equal per query, except for documents tied
    at the depth cut: equal sorted scores, equal (id, score) sets above
    the lowest score."""
    (gs, gi), (ws, wi) = got, want
    assert len(gs) == len(ws)
    for q, (a, b, c, d) in enumerate(zip(gs, gi, ws, wi)):
        assert sorted(map(float, a)) == sorted(map(float, c)), q
        if len(a):
            cut = min(map(float, a))
            assert {(x, float(s)) for x, s in zip(b, a) if s > cut} == \
                {(x, float(s)) for x, s in zip(d, c) if s > cut}, q


def close_rows(got, want):
    """Dense rows: the same ids in order, scores within ``TOL``."""
    (gs, gi), (ws, wi) = got, want
    assert [list(map(str, r)) for r in gi] == [list(map(str, r)) for r in wi]
    np.testing.assert_allclose(np.asarray(gs, np.float64),
                               np.asarray(ws, np.float64), **TOL)


# ---- the draws --------------------------------------------------------------

def test_draws_equal_the_jax_tools(monkeypatch):
    import bench

    jmod = jax_tool("serve_loadtest", monkeypatch)
    args = serve_loadtest.build_parser().parse_args(
        ["--docs", "600", "--terms", "300", "--doc-k", "16", "--q-k", "8",
         "--dim", "8", "--n-queries", "40"])
    ji, jd, jp, jrng = jmod.build_indexes(args)
    pi, pd, pp_, prng = serve_loadtest.build_indexes(args, "cpu")
    np.testing.assert_array_equal(pi.doc_terms, ji.doc_terms)
    np.testing.assert_array_equal(pi.doc_weights, ji.doc_weights)
    np.testing.assert_array_equal(np.concatenate(pd._chunks),
                                  np.concatenate(jd._chunks))
    np.testing.assert_array_equal(pp_, jp)
    jt, jdq = jmod.make_queries(args, jp, jrng)
    pt, pdq = serve_loadtest.make_queries(args, pp_, prng)
    assert pt == jt
    np.testing.assert_array_equal(pdq, jdq)
    # bench.py's headline corpus and queries (cache_probe's copy)
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    for got, want in zip(cache_probe.build_corpus(a) + cache_probe.
                         build_queries(a),
                         bench.build_corpus(b) + bench.build_queries(b)):
        np.testing.assert_array_equal(got, want)
    # the unchunked draw of latency_profile / live_ab is the same stream
    p = common.zipf_p(300)
    want = np.random.default_rng(1).choice(300, size=(5000, 4), p=p)
    got, _ = common.zipf_docs(np.random.default_rng(1), 5000, 300, 4, p)
    np.testing.assert_array_equal(got, want)
    jann = jax_tool("ann_ab", monkeypatch)
    np.testing.assert_array_equal(
        ann_ab._spectral_corpus(np.random.default_rng(2), 50, 16),
        jann._spectral_corpus(np.random.default_rng(2), 50, 16))


# ---- serve_loadtest ---------------------------------------------------------

# the smoke widths, with a depth at the corpus size (--smoke would reset
# the depth levels to 10)
SMALL = ["--docs", "512", "--terms", "256", "--doc-k", "16", "--q-k", "8",
         "--dim", "16", "--max-batch", "64", "--clients", "4"]
SERVE = SMALL + ["--n-queries", "48", "--depth", "512", "--depth-levels",
                 "512"]


def served(monkeypatch, cls):
    """Record every ``cls.search_async`` request and its future."""
    calls, real = [], cls.search_async
    sig = inspect.signature(real)

    def wrapper(self, *a, **k):
        fut = real(self, *a, **k)
        bound = sig.bind(self, *a, **k)
        calls.append((dict(bound.arguments), fut))
        return fut

    monkeypatch.setattr(cls, "search_async", wrapper)
    return calls


def request_key(kw):
    if kw.get("text") is not None:
        return ("text", kw["text"])
    terms = kw.get("terms") or {}
    dense = kw.get("dense")
    return (tuple(sorted((int(t), float(w)) for t, w in terms.items())),
            None if dense is None
            else tuple(np.round(np.asarray(dense, np.float64), 5)))


def assert_served_rows_equal(got, jcalls, terms, denses, mode):
    want = {}
    for kw, fut in jcalls:
        want.setdefault(request_key(kw), fut.result())
    assert len(got) == serve_loadtest.KEEP_ROWS
    for i, rows in got.items():
        key = request_key({"terms": terms[i] if terms else None,
                           "dense": denses[i] if denses is not None
                           else None})
        w = {(d, float(s)) for d, s in want[key]}
        assert {d for d, _ in rows} == {d for d, _ in w}, i
        if mode == "sparse":
            assert set(rows) == w, i
        else:
            ws = dict(w)
            np.testing.assert_allclose([s for _, s in rows],
                                       [ws[d] for d, _ in rows], **TOL)


@pytest.mark.parametrize("mode,transport", [
    ("sparse", "inproc"), ("dense", "http"), ("hybrid", "http"),
    ("hybrid", "inproc")])
def test_serve_loadtest_matches_jax(mode, transport, monkeypatch, capsys):
    from mllm_sparse_retrieval_tpu.serving import service as jservice

    jmod = jax_tool("serve_loadtest", monkeypatch)
    argv = SERVE + ["--mode", mode, "--transport", transport]
    jcalls = served(monkeypatch, jservice.RetrievalService)
    assert jmod.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = serve_loadtest.main(argv + CPU)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == set(want) and set(got) - set(printed) == {
        "rows", "answered"}
    assert got["answered"] == got["n_queries"] == 48
    args = serve_loadtest.build_parser().parse_args(argv)
    _, _, p, rng = serve_loadtest.build_indexes(args, "cpu")
    terms, denses = serve_loadtest.make_queries(args, p, rng)
    assert_served_rows_equal(
        got["rows"], jcalls, terms if mode != "dense" else None,
        denses if mode != "sparse" else None, mode)


@pytest.mark.parametrize("extra", [
    ["--mode", "sparse", "--transport", "http"],
    ["--mode", "dense", "--transport", "inproc"],
    ["--live", "--live-impl", "arena", "--transport", "inproc"],
    ["--live", "--live-impl", "segments", "--transport", "http",
     "--http-impl", "threaded"]])
def test_serve_loadtest_json_keys_match_jax(extra, monkeypatch, capsys):
    jmod = jax_tool("serve_loadtest", monkeypatch)
    argv = SMALL + ["--n-queries", "16", "--depth-levels", "10",
                    "--write-interval-ms", "50"] + extra
    assert jmod.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = serve_loadtest.main(argv + CPU)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == set(want)
    if "live" in want:
        assert set(printed["live"]) == set(want["live"])
        assert printed["live"]["writes"] > 0
    assert got["answered"] == 16


def test_serve_loadtest_text_kind_matches_jax(data, monkeypatch, capsys):
    import mllm_sparse_retrieval_tpu.data as jdata
    from mllm_sparse_retrieval_tpu import models as jmodels
    from mllm_sparse_retrieval_tpu.serving import service as jservice

    jmod = jax_tool("serve_loadtest", monkeypatch)
    monkeypatch.setattr(jdata, "CrossModalCorpus",
                        lambda name, split, _root: JCorpus(name, split,
                                                           str(data)))
    builds = recording(monkeypatch, jmodels, "build_model")
    jcalls = served(monkeypatch, jservice.RetrievalService)
    argv = ["--mode", "sparse", "--transport", "inproc", "--query-kind",
            "text", "--n-queries", "16", "--clients", "4", "--max-batch",
            "64", "--depth", "64", "--depth-levels", "64"]
    assert jmod.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = serve_loadtest.main(argv + CPU + ["--data-root", str(data)],
                              model=carried(builds[0]))
    assert set(got) - {"rows", "answered"} == set(want)
    assert got["query_kind"] == "text" and got["docs"] == want["docs"]
    jrows = {kw["text"]: fut.result() for kw, fut in jcalls}
    texts = [ex.text for ex in JCorpus("flickr", "test", str(data))
             .examples_full()]
    for i, rows in got["rows"].items():
        assert set(rows) == {(d, float(s)) for d, s in
                             jrows[texts[i % len(texts)]]}, i


# ---- latency_profile, engine_ab, live_ab ------------------------------------

def test_latency_profile_streams_equal_jax(monkeypatch, capsys):
    from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JIndex

    jmod = jax_tool("latency_profile", monkeypatch)
    argv = ["--docs", "300", "--batch", "16", "--depth", "300", "--rounds",
            "2", "--warm", "1"]
    jstreams = recording_stream(monkeypatch, JIndex, "search_encoded_stream")
    run_jax(jmod, argv, monkeypatch)
    got = latency_profile.main(argv + CPU)
    out = capsys.readouterr().out
    assert "per-batch latency ms: p50" in out and got["p99"] > 0
    same_up_to_ties(got["first"], jstreams[0][1])


def test_engine_ab_paths_equal_jax(monkeypatch):
    from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JIndex

    jmod = jax_tool("engine_ab", monkeypatch)
    argv = ["--docs", "200", "--terms", "120", "--doc-k", "8",
            "--query-terms", "4", "--batch", "8", "--rounds", "1",
            "--reps", "1"]
    arrays = recording_stream(monkeypatch, JIndex, "search_encoded_stream")
    run_jax(jmod, argv, monkeypatch)
    got = engine_ab.main(argv + CPU)
    same_up_to_ties(got["first"]["arrays"], arrays[0][0])
    # the id-keyed path gives the array path's rows
    same_up_to_ties(got["first"]["engine"], got["first"]["arrays"])


def test_live_ab_base_legs_equal_jax(monkeypatch):
    from mllm_sparse_retrieval_tpu import index as jindex
    from mllm_sparse_retrieval_tpu.index.dense import DenseFlatIndex
    from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex

    jmod = jax_tool("live_ab", monkeypatch)
    argv = ["--docs", "400", "--terms", "150", "--doc-k", "8", "--q-k", "4",
            "--dim", "8", "--batch", "16", "--delta-docs", "8", "--reps",
            "1"]
    rec = {name: recording(monkeypatch, owner, method) for name, owner,
           method in (
        ("sparse_static", ImpactIndex, "search_encoded"),
        ("sparse_live_base", jindex.LiveImpactIndex, "search_rows"),
        ("sparse_arena_base", jindex.ArenaImpactIndex, "search_rows"),
        ("dense_static", DenseFlatIndex, "search_ids"),
        ("dense_live_base", jindex.LiveDenseIndex, "search_rows"),
        ("dense_arena_base", jindex.ArenaDenseIndex, "search_rows"))}
    run_jax(jmod, argv, monkeypatch)
    got = live_ab.main(argv + CPU)
    assert set(got["rows"]) == {
        f"{e}_{leg}" for e in ("sparse", "dense") for leg in (
            "static", "live_base", "arena_base", "live_deltas",
            "arena_mutated")}
    first = got["first"]
    for name in ("sparse_static", "sparse_live_base", "sparse_arena_base"):
        same_up_to_ties(first[name], rec[name][0][2])
        same_up_to_ties(first[name], first["sparse_static"])
    for name in ("dense_static", "dense_live_base", "dense_arena_base"):
        close_rows(first[name], rec[name][0][2])


def test_placed_matrix_keeps_the_last_write_of_a_repeated_cell():
    """live_ab's corpus repeats (doc, term) pairs with other weights: the
    placed matrix holds the last of them in CSR order (term ascending,
    weight descending), so every placement of one corpus, on the card as
    here, is the same matrix."""
    from mllm_sparse_retrieval_tpu_torch.index import ImpactIndex

    doc_t, doc_w = common.zipf_docs(np.random.default_rng(0), 300, 50, 16,
                                    common.zipf_p(50))
    index = ImpactIndex.from_packed_arrays(doc_t, doc_w,
                                           term_keys=range(50), device="cpu")
    want = np.zeros((51, 300), np.float32)
    for t, d, w in sorted(zip(doc_t.ravel(), np.repeat(np.arange(300), 16),
                              doc_w.ravel()), key=lambda x: (x[0], -x[2])):
        want[t + 1, d] = w
    assert (doc_t[:, :, None] == doc_t[:, None, :]).sum() > doc_t.size
    got = index._materialize("f32").numpy()
    np.testing.assert_array_equal(got[:, :300], want)


# ---- hybrid_ab, eval_ab -------------------------------------------------------

def fused_rows(scores, ids):
    return [dict(zip(i, map(float, s))) for s, i in zip(scores, ids)]


def test_hybrid_ab_device_fuse_equals_host_and_jax(monkeypatch):
    from mllm_sparse_retrieval_tpu.search import device_fusion as jdf

    jmod = jax_tool("hybrid_ab", monkeypatch)
    argv = ["--docs", "160", "--dim", "8", "--terms", "100", "--doc-k", "8",
            "--query-terms", "4", "--batch", "8", "--depth", "160",
            "--out-depth", "20", "--rounds", "1", "--reps", "1"]
    jfused = recording(monkeypatch, jdf.FusedHybridSearcher,
                       "search_encoded")
    run_jax(jmod, argv, monkeypatch)
    got = hybrid_ab.main(argv + CPU)
    dev = fused_rows(*got["first"]["device"])
    host = got["first"]["host"]
    want = fused_rows(*jfused[0][2])
    for q, qid in enumerate(got["qids"]):
        h = {d: float(s) for d, s in host[qid].items()}
        for other in (h, want[q]):
            assert set(dev[q]) == set(other), q
            np.testing.assert_allclose([dev[q][d] for d in other],
                                       list(other.values()), **TOL)


def test_eval_ab_recall_equals_jax(monkeypatch, capsys):
    jmod = jax_tool("eval_ab", monkeypatch)
    argv = ["--docs", "160", "--dim", "8", "--terms", "100", "--doc-k", "8",
            "--query-terms", "4", "--batch", "8", "--depth", "160",
            "--rounds", "1", "--reps", "1"]
    host = recording(monkeypatch, jmod, "recall_at_k")
    dev = recording(monkeypatch, jmod, "metrics_from_ranks")
    run_jax(jmod, argv, monkeypatch)
    got = eval_ab.main(argv + CPU)
    assert got["parity"] and "parity: device-consumer recall" in \
        capsys.readouterr().out
    want = {"sparse/host": host[0][2].recalls,
            "sparse/dev": dev[0][2][0].recalls,
            "hybrid/host": host[1][2].recalls,
            "hybrid/fused": host[2][2].recalls,
            "hybrid/dev": dev[1][2][0].recalls}
    assert got["recall"] == want


def test_eval_ab_exits_1_when_a_leg_disagrees(monkeypatch, capsys):
    """The device consumer made to find no target: its recall differs
    from the host consumer's and the tool reports the mismatch."""
    from mllm_sparse_retrieval_tpu_torch.eval import device_eval

    real = device_eval.impact_eval_ranks

    def no_targets(*a, **k):
        ranks = real(*a, **k)
        ranks[:, 1:] = -1
        return ranks

    monkeypatch.setattr(device_eval, "impact_eval_ranks", no_targets)
    got = eval_ab.main(["--docs", "160", "--dim", "8", "--terms", "100",
                        "--doc-k", "8", "--query-terms", "4", "--batch",
                        "8", "--depth", "160", "--rounds", "1",
                        "--sparse-only"] + CPU)
    assert not got["parity"] and "ms" not in got
    assert "FAIL: sparse recall mismatch" in capsys.readouterr().out


# ---- dense_ab, ann_ab, mxu_probe --------------------------------------------

def test_dense_ab_topk_equals_jax(monkeypatch):
    from mllm_sparse_retrieval_tpu.index.dense import DenseFlatIndex as JD

    jmod = jax_tool("dense_ab", monkeypatch)
    argv = ["--docs", "200", "--dim", "32", "--batch", "40", "--reps", "1"]
    searches = recording(monkeypatch, JD, "search")
    run_jax(jmod, argv, monkeypatch)
    got = dense_ab.main(argv + CPU)
    (js32, ji32), (_, ji16), (js8, ji8) = (c[2] for c in searches[-3:])
    s32, i32 = got["topk"]["f32"]
    np.testing.assert_array_equal(i32, np.asarray(ji32))
    np.testing.assert_allclose(s32, np.asarray(js32), **TOL)
    s8, i8 = got["topk"]["int8"]
    np.testing.assert_array_equal(s8, np.asarray(js8))
    np.testing.assert_array_equal(i8, np.asarray(ji8))
    ji32, ji16 = np.asarray(ji32), np.asarray(ji16)
    jover = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ji32, ji16)])
    assert abs(got["overlap"]["bf16"] - jover) <= BF16_OVERLAP_TOL


def test_ann_ab_candidate_recall_equals_jax(monkeypatch):
    from mllm_sparse_retrieval_tpu.index.dense import DenseFlatIndex as JD

    jmod = jax_tool("ann_ab", monkeypatch)
    argv = ["--docs", "1500", "--dim", "16", "--batch", "24", "--rank", "4",
            "--candidates", "16", "--reps", "1"]
    jids = recording(monkeypatch, JD, "search_ids")
    run_jax(jmod, argv, monkeypatch)
    got = ann_ab.main(argv + CPU)
    (_, exact), (_, ann) = (c[2] for c in jids[-2:])
    want = sum(len(set(a) & set(e)) for a, e in zip(ann, exact)) / (
        10 * len(exact))
    assert got["recall"] == want
    assert [list(r) for r in got["ids"]["exact"]] == [list(r) for r in exact]


def test_mxu_probe_full_leg_equals_jax_mips_topk():
    from mllm_sparse_retrieval_tpu.ops.mips import mips_topk

    got = mxu_probe.main(["--docs", "256", "--dim", "32", "--batch", "16",
                          "--reps", "1"] + CPU)
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((256, 32)).astype(np.float32)
    q = rng.standard_normal((16, 32)).astype(np.float32)
    ws, wi = mips_topk(q, corpus, 10)
    s, i = got["full_topk"]
    np.testing.assert_array_equal(i, np.asarray(wi))
    np.testing.assert_allclose(s, np.asarray(ws), **TOL)
    for name in ("f32", "bf16", "int8"):
        assert set(got[name]) == {"sum_ms", "out_ms", "full_ms",
                                  "peak_share"}


# ---- scaling_report -----------------------------------------------------------

def test_scaling_report_bytes_equal_jax(monkeypatch):
    import jax
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mllm_sparse_retrieval_tpu.models import llama as jllama
    from mllm_sparse_retrieval_tpu.parallel import pp as jpp
    from mllm_sparse_retrieval_tpu.parallel.fsdp import fsdp_shardings
    from mllm_sparse_retrieval_tpu.parallel.mesh import make_mesh
    from mllm_sparse_retrieval_tpu.parallel.tp import tp_param_shardings
    from mllm_sparse_retrieval_tpu.train.trainer import zero1_shardings

    jmod = jax_tool("scaling_report", monkeypatch)
    n = 8
    pc = scaling_report.report_config()
    cfg = jllama.LlamaConfig(
        vocab_size=pc.vocab_size, hidden_size=pc.hidden_size,
        num_layers=pc.num_layers, num_heads=pc.num_heads,
        num_kv_heads=pc.num_kv_heads,
        intermediate_size=pc.intermediate_size)
    params = jax.eval_shape(lambda k: jllama.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    opt = jax.eval_shape(optax.adam(1e-4).init, params)
    mesh_dp = make_mesh(data_parallel=n, model_parallel=1)
    mesh_tp = make_mesh(data_parallel=n // 2, model_parallel=2)
    mesh3 = jpp.make_pp3_mesh(n // 4, 2, 2)
    stacked = jax.eval_shape(
        lambda p: jpp.stack_block_params(p["blocks"]), params)

    def repl(tree):
        return jax.tree_util.tree_map(
            lambda _: NamedSharding(mesh_dp, P()), tree)

    want = [jmod._bytes_per_device(tree, sh, n) for tree, sh in (
        (params, repl(params)), (params, fsdp_shardings(params, mesh_dp)),
        (params, tp_param_shardings(params, mesh_tp)), (opt, repl(opt)),
        (opt, zero1_shardings(opt, mesh_dp)),
        (stacked, jpp.stacked_tp_shardings(stacked, mesh3)))]
    trees = scaling_report.shape_trees(pc)
    got = scaling_report.byte_rows(*trees, n, ["cpu"] * n)
    assert [b for _, b in got] == want
    assert [name for name, _ in got] == [
        "replicated (reference DDP)", "FSDP / ZeRO-3 params",
        "megatron TP (model=2) params", "adam state replicated",
        "adam state ZeRO-1", "pp x tp stacked blocks (pipe=2, model=2)"]


def test_scaling_report_census_is_pinned():
    from mllm_sparse_retrieval_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=128, num_layers=4,
                            num_heads=4, num_kv_heads=2,
                            intermediate_size=256)
    got = scaling_report.census(cfg, 8, ["cpu"] * 8, seq=8)

    def counts(ar, ag, rs, cp):
        return {"all-reduce": ar, "all-gather": ag, "reduce-scatter": rs,
                "collective-permute": cp, "all-to-all": 0}

    # FSDP: each of 8 shards gathers the split embedding, the LM head
    # (which the step does not use: no gradient comes back) and the 4
    # blocks' split weights at use; TP: every block's 7 projections are
    # split over the model axis, once per data row of 4; dp x pp x tp: the
    # same on 2 data rows x 2 microbatches, plus one stage hand-off per
    # data row and microbatch, forward and backward
    assert got == {
        "FSDP grad step": counts(0, 176, 168, 0),
        "TP (model=2) grad step": counts(112, 112, 0, 0),
        "dp x pp x tp pipeline step": counts(112, 112, 0, 8)}


# ---- cache_probe ----------------------------------------------------------------

def test_cache_probe_names_and_hits(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    prints = tmp_path / "fingerprints.jsonl"
    argv = ["--skip-compile", "--fingerprints", str(prints)] + CPU
    first = cache_probe.main(argv)
    for src in cache_probe.SOURCES:
        assert first["sources"][src]["library"] == \
            cuda_build.library_path(src).name
        assert first["sources"][src]["hit"] is False
    lib = cuda_build.library_path("taat.cu")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    second = cache_probe.main(argv)
    assert second["sources"]["taat.cu"]["hit"] is True
    assert second["sources"]["flash_attn.cu"]["hit"] is False
    assert [json.loads(ln)["sources"]["taat.cu"]["hit"] for ln in
            prints.read_text().splitlines()] == [False, True]
    assert json.loads(capsys.readouterr().out.split("}\n{")[0] + "}")[
        "nvcc_flags"] == " ".join(cuda_build.NVCC_FLAGS)


# ---- examples/smoke -------------------------------------------------------------

def test_examples_smoke_matches_jax(data, monkeypatch):
    from mllm_sparse_retrieval_tpu import models as jmodels

    jmod = jax_tool("smoke", monkeypatch, folder="examples")
    builds = recording(monkeypatch, jmodels, "build_model")
    sims = recording(monkeypatch, jmod, "cosine_similarity_matrix")
    encs = recording(monkeypatch, jmod, "encode_examples")
    argv = ["--data-root", str(data), "--dtype", "float32"]
    jmod.main(argv)
    got = smoke.main(argv + CPU, model=carried(builds[0]))
    np.testing.assert_allclose(got["sims"], np.asarray(sims[0][2]), **TOL)

    def top(vec):
        return sorted(vec.items(), key=lambda kv: -kv[1])[:10]

    assert got["image_terms"] == top(encs[0][2].sparse_vectors[0])
    assert got["caption_terms"] == top(encs[1][2].sparse_vectors[0])


# ---- no card ----------------------------------------------------------------------

@pytest.mark.parametrize("main", [
    serve_loadtest.main, latency_profile.main, engine_ab.main,
    hybrid_ab.main, eval_ab.main, live_ab.main, dense_ab.main, ann_ab.main,
    mxu_probe.main, scaling_report.main, cache_probe.main, smoke.main],
    ids=lambda m: m.__module__.rsplit(".", 1)[-1])
def test_tools_refuse_cuda_without_a_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])

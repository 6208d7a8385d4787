"""PyTorch port, the segment live indexes (``index/live.py``) against the
JAX package's ``LiveImpactIndex`` / ``LiveDenseIndex`` on the same seeded
operation sequences, the host helpers ``_merge_rows``, ``_fetch_depth`` and
``_bucket`` against JAX's Python bodies exactly, and the background
compactor, the write stall and ``close()``.

Tolerances: results compare as ``(score, id)`` rows up to ties at the cut
(``test_torch_arena.assert_rows_equal``); impact scores are integers and
equal exactly, dense scores within 1e-5. The helpers must return equal
values. Each test that starts threads ends them within its own limit.
"""

import threading
import time

import numpy as np
import pytest

from mllm_sparse_retrieval_tpu.index import live as jlive
from mllm_sparse_retrieval_tpu.index.dense import DenseFlatIndex as JDense
from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpact
from mllm_sparse_retrieval_tpu_torch.index import (
    DenseFlatIndex, ImpactIndex, LiveDenseIndex, LiveImpactIndex)
from mllm_sparse_retrieval_tpu_torch.index import live as plive
from tests.test_torch_arena import (
    DENSE_TOL, THREAD_LIMIT_S, _int_reps, _oracle_sparse, _queries,
    _sparse_docs, assert_rows_equal)


@pytest.mark.parametrize("n,minimum", [(0, 1), (1, 1), (5, 4), (256, 256),
                                       (257, 256), (1000, 1)])
def test_bucket_matches_jax(n, minimum):
    assert plive._bucket(n, minimum) == jlive._bucket(n, minimum)


@pytest.mark.parametrize("depth,extra,size", [(10, 0, 0), (10, 0, 5),
                                              (10, 0, 50), (10, 3, 50),
                                              (10, 9, 12), (100, 33, 1000)])
def test_fetch_depth_matches_jax(depth, extra, size):
    assert plive._fetch_depth(depth, extra, size) == \
        jlive._fetch_depth(depth, extra, size)


def test_merge_rows_matches_jax_python_body(monkeypatch):
    """Ties across segments, tombstones, pad rows, short rows and the depth
    cut: the port's merge equals the JAX Python body (``hostops`` off)."""
    monkeypatch.setattr(jlive._hostops, "get", lambda: None)
    rng = np.random.default_rng(0)
    per_segment, p_segs, j_segs = [], [], []
    for s in range(4):
        rows_s, rows_i = [], []
        for q in range(5):
            k = int(rng.integers(0, 8))
            scores = sorted(rng.integers(0, 6, k).astype(float).tolist(),
                            reverse=True)
            ids = [f"s{s}d{int(i)}" for i in rng.integers(0, 10, k)]
            if s == 2 and k:
                ids[-1] = plive._PAD_ID
            rows_s.append(scores)
            rows_i.append(ids)
        per_segment.append((rows_s, rows_i))
        tomb = {f"s{s}d{i}" for i in range(0, 10, 3)}
        n_pad = 3 if s == 2 else 0
        p_segs.append(plive._Segment(None, set(), tomb, n_pad))
        j_segs.append(jlive._Segment(None, set(), tomb, n_pad))
    assert plive._PAD_ID == jlive._PAD_ID
    for depth in (1, 4, 100):
        assert plive._merge_rows(per_segment, p_segs, depth) == \
            jlive._merge_rows(per_segment, j_segs, depth)


def test_live_impact_workload_matches_jax():
    """A base, deltas with new terms, replaces, deletes, auto compaction
    past ``max_delta_segments``, a full compaction; the base searched by
    the TAAT route (the plain version here), deltas by matmul."""
    rng = np.random.default_rng(1)
    vocab = np.arange(70)
    state = _sparse_docs(rng, [f"b{i}" for i in range(25)], vocab[:50], 5)
    jbase, pbase = JImpact(), ImpactIndex(device="cpu")
    jbase.add_many(state.items())
    pbase.add_many(state.items())
    jl = jlive.LiveImpactIndex(jbase, max_delta_segments=2)
    pl = LiveImpactIndex(pbase, max_delta_segments=2)
    q = _queries(rng, vocab, 5)

    def check(depth=8):
        got = pl.search_rows(q, depth, backend="taat")
        assert_rows_equal(got, jl.search_rows(q, depth, backend="matmul"))
        assert_rows_equal(got, _oracle_sparse(state, q, depth))
        assert pl.num_docs == jl.num_docs == len(state)
        assert pl.num_segments == jl.num_segments

    check()
    for step in range(5):
        docs = _sparse_docs(rng, [f"d{step}_{i}" for i in range(4)], vocab,
                            5)
        docs[f"b{step}"] = {int(vocab[60 + step]): 11}
        for idx in (jl, pl):
            idx.add_documents(list(docs.items()))
        state.update(docs)
        dead = [f"b{10 + step}", f"d{step}_0"]
        assert pl.delete_documents(dead) == jl.delete_documents(dead)
        for d in dead:
            state.pop(d)
        check()
    for idx in (jl, pl):
        idx.compact()
    assert pl.num_segments == 1
    check(depth=40)


def test_live_dense_workload_matches_jax():
    rng = np.random.default_rng(2)
    d = 8
    ids = [f"b{i}" for i in range(20)]
    reps = _int_reps(rng, 20, d)
    jbase, pbase = JDense(), DenseFlatIndex(device="cpu")
    jbase.add(reps, ids)
    pbase.add(reps, ids)
    jl = jlive.LiveDenseIndex(jbase, bucket_min=4, max_delta_segments=2)
    pl = LiveDenseIndex(pbase, bucket_min=4, max_delta_segments=2)
    q = _int_reps(rng, 4, d)

    def check(depth=10):
        assert_rows_equal(pl.search_rows(q, depth, batch_size=4),
                          jl.search_rows(q, depth, batch_size=4), DENSE_TOL)
        assert pl.num_docs == jl.num_docs
        assert pl.num_segments == jl.num_segments

    for step in range(4):
        new = _int_reps(rng, 3, d)
        new_ids = [f"n{step}_0", f"n{step}_1", f"b{step}"]
        for idx in (jl, pl):
            idx.add_documents(new, new_ids)
            idx.delete_documents([f"b{8 + step}"])
        check()
    for idx in (jl, pl):
        idx.compact()
    check(depth=30)
    with pytest.raises(ValueError):
        pl.add_documents(_int_reps(rng, 1, d + 1), ["x"])
    with pytest.raises(ValueError):
        pl.add_documents(_int_reps(rng, 1, d), [plive._PAD_ID])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_live_save_in_one_package_load_in_the_other(tmp_path, writer):
    rng = np.random.default_rng(3)
    vocab = np.arange(30)
    docs = _sparse_docs(rng, [f"a{i}" for i in range(10)], vocab, 4)
    jl = jlive.LiveImpactIndex(None, max_delta_segments=4)
    pl = LiveImpactIndex(None, max_delta_segments=4, device="cpu")
    more = _sparse_docs(rng, ["m0", "m1", "a2"], vocab, 4)
    for idx in (jl, pl):
        idx.add_documents(list(docs.items()))
        idx.add_documents(list(more.items()))
        idx.delete_documents(["a5"])
    src = jl if writer == "jax" else pl
    src.save(str(tmp_path / "s"))
    back = (LiveImpactIndex.load(str(tmp_path / "s"), device="cpu")
            if writer == "jax" else
            jlive.LiveImpactIndex.load(str(tmp_path / "s")))
    q = _queries(rng, vocab, 4)
    assert back.num_segments == 2 and back.num_docs == 11
    assert_rows_equal(back.search_rows(q, 8), pl.search_rows(q, 8))


def test_background_compaction_converges_serves_and_closes():
    rng = np.random.default_rng(4)
    live = LiveDenseIndex(None, bucket_min=4, max_delta_segments=2,
                          background_compaction=True, device="cpu")
    state = {}
    try:
        for batch in range(8):
            ids = [f"s{batch}_{i}" for i in range(3)]
            reps = _int_reps(rng, 3, 8)
            live.add_documents(reps, ids)
            state.update(zip(ids, reps))
        live.delete_documents(["s0_0"])
        state.pop("s0_0")
        live.wait_compacted(timeout=THREAD_LIMIT_S)
        assert live.num_segments <= 3
        oracle = DenseFlatIndex(device="cpu")
        oracle.add(np.stack(list(state.values())), list(state))
        q = _int_reps(rng, 3, 8)
        s, i = oracle.search_ids(q, 8)
        assert_rows_equal(live.search_rows(q, 8, batch_size=4),
                          (s.tolist(), i), DENSE_TOL)
        compactor = live._compactor
        assert compactor is not None and compactor.is_alive()
    finally:
        live.close()
    compactor.join(THREAD_LIMIT_S)
    assert not compactor.is_alive()
    live.close()                         # idempotent


def test_write_stall_bounds_the_segment_count():
    rng = np.random.default_rng(5)
    live = LiveDenseIndex(max_delta_segments=2, bucket_min=1,
                          background_compaction=True,
                          max_stalled_segments=6, device="cpu")
    orig = live._merge_segments
    peak = 0

    def slow_merge(segs, tombs):
        time.sleep(0.02)
        return orig(segs, tombs)

    live._merge_segments = slow_merge
    try:
        for i in range(30):
            live.add_documents(_int_reps(rng, 1, 4), [f"d{i}"])
            peak = max(peak, live.num_segments)
        assert peak - 1 <= live.max_stalled_segments + 1, peak
        live.wait_compacted(timeout=THREAD_LIMIT_S)
        assert live.num_docs == 30
    finally:
        live.close()


def test_close_releases_a_stalled_writer():
    live = LiveImpactIndex(max_delta_segments=1, background_compaction=True,
                           max_stalled_segments=1, device="cpu")
    release = threading.Event()
    orig = live._merge_segments

    def stuck_merge(segs, tombs):
        release.wait(THREAD_LIMIT_S)
        return orig(segs, tombs)

    live._merge_segments = stuck_merge
    docs = [(f"d{i}", {i % 7: 1 + i % 3, 7 + i % 5: 2}) for i in range(8)]
    done = threading.Event()

    def writer():
        for d in docs:
            live.add_documents([d])
        done.set()

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    time.sleep(0.3)                      # let it stall
    assert not done.is_set()
    live.close()
    try:
        assert done.wait(5.0), "writer stayed stalled after close()"
    finally:
        release.set()
    t.join(THREAD_LIMIT_S)
    live._compactor.join(THREAD_LIMIT_S)
    assert not t.is_alive() and not live._compactor.is_alive()

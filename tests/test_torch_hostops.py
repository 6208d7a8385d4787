"""PyTorch port, ``hostops`` (the C host helpers of runs, fusion, the query
encode and the live merge) against the port's Python bodies and the JAX
package's extension on the same seeded inputs, the corner inputs that make
the callers take the Python body included (non-list rows, non-int32 rows,
entries of a surprising shape). Tolerance: none; every result is equal
(run dicts and fused doubles compared with ``==``, arrays with
``assert_array_equal``). Then the loader: a failed build raises, and the
callers' calls are counted."""

import os
import random

import numpy as np
import pytest

from mllm_sparse_retrieval_tpu import hostops as jhostops
from mllm_sparse_retrieval_tpu.index import live as jlive
from mllm_sparse_retrieval_tpu.search.fusion import fuse as jfuse
from mllm_sparse_retrieval_tpu.search.runs import make_run as jmake_run
from mllm_sparse_retrieval_tpu_torch import hostops
from mllm_sparse_retrieval_tpu_torch.index import impact as impact_mod
from mllm_sparse_retrieval_tpu_torch.index import live as live_mod
from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex
from mllm_sparse_retrieval_tpu_torch.search import fusion as fusion_mod
from mllm_sparse_retrieval_tpu_torch.search import runs as runs_mod
from mllm_sparse_retrieval_tpu_torch.search.fusion import fuse
from mllm_sparse_retrieval_tpu_torch.search.runs import make_run
from mllm_sparse_retrieval_tpu_torch.sparse import SelectedTerms


@pytest.fixture(scope="module")
def native():
    return hostops.get().ext


@pytest.fixture(scope="module")
def jnative():
    ext = jhostops.get()
    assert ext is not None
    return ext


class _Refusing:
    """Stands in for the extension: every array helper refuses its input,
    so ``encode_query_terms`` runs its numpy body."""

    @staticmethod
    def get():
        return _Refusing()

    def encode_terms(self, *args):
        return False

    def stack_rows(self, *args):
        return False


def _ragged_run_inputs(seed, n=50, k=12):
    rng = np.random.default_rng(seed)
    qids = [f"d{3 * i}" for i in range(n)]
    scores, ids = [], []
    for i in range(n):
        row = rng.normal(size=rng.integers(0, k + 1)).tolist()
        scores.append(row)
        row_ids = [f"d{int(x)}" for x in rng.integers(0, 3 * n, len(row))]
        if row and i % 3 == 0:                     # self hits
            row_ids[rng.integers(0, len(row))] = qids[i]
        ids.append(row_ids)
    return qids, scores, ids


@pytest.mark.parametrize("remove_query", [False, True])
@pytest.mark.parametrize("scores_sorted", [False, True])
def test_build_runs_equals_python_and_jax(native, jnative, remove_query,
                                          scores_sorted):
    qids, scores, ids = _ragged_run_inputs(0)
    if scores_sorted:
        scores = [sorted(r, reverse=True) for r in scores]
    hostops.reset_call_counts()
    got = make_run(qids, scores, ids, remove_query=remove_query,
                   scores_sorted=scores_sorted)
    assert hostops.call_counts()["build_runs"] == 1
    want = runs_mod._make_run_python(qids, scores, ids, remove_query,
                                     scores_sorted)
    assert got == want
    assert got == jnative.build_runs(qids, scores, ids, remove_query,
                                     scores_sorted)
    assert got == jmake_run(qids, scores, ids, remove_query=remove_query,
                            scores_sorted=scores_sorted)


def test_build_runs_numeric_coercion_matches(native):
    qids = [np.str_("q0"), 7]
    scores = [[np.float32(1.5), np.float64(0.25)], []]
    ids = [[np.str_("a"), "b"], []]
    got = make_run(qids, scores, ids)
    assert got == runs_mod._make_run_python(qids, scores, ids)
    assert got == jmake_run(qids, scores, ids)
    assert got["q0"]["docs"]["a"] == 1.5
    assert got["7"] == {"docs": {}, "min_score": 0.0, "max_score": 0.0}


def test_build_runs_rejects_non_list_rows(native):
    """Tuple rows raise TypeError in C; ``make_run`` takes the Python body
    and still succeeds, as the JAX package's does."""
    with pytest.raises(TypeError):
        native.build_runs(["q"], [(1.0, 0.5)], [("a", "b")], False, False)
    out = make_run(["q"], [(1.0, 0.5)], [("a", "b")])
    assert out["q"]["docs"] == {"a": 1.0, "b": 0.5}
    assert out == jmake_run(["q"], [(1.0, 0.5)], [("a", "b")])
    # a length mismatch raises ValueError in C and zip-truncates in Python
    short = make_run(["q", "r"], [[1.0]], [["a"]])
    assert short == {"q": {"docs": {"a": 1.0}, "min_score": 1.0,
                           "max_score": 1.0}}


def test_stack_rows_matches_numpy_and_jax(native, jnative):
    rng = np.random.default_rng(1)
    b, w = 40, 16
    rows = [SelectedTerms(rng.integers(0, 999, w).astype(np.int32),
                          rng.integers(1, 99, w).astype(np.int32))
            for _ in range(b)]
    ti, tw, jti, jtw = (np.empty((b, w), np.int32) for _ in range(4))
    assert native.stack_rows(rows, "token_ids", "weights", ti, tw)
    assert jnative.stack_rows(rows, "token_ids", "weights", jti, jtw)
    np.testing.assert_array_equal(ti, np.stack([r.token_ids for r in rows]))
    np.testing.assert_array_equal(tw, np.stack([r.weights for r in rows]))
    np.testing.assert_array_equal(ti, jti)
    np.testing.assert_array_equal(tw, jtw)


def test_stack_rows_refuses_wrong_dtype_or_shape(native):
    b, w = 4, 8
    ti = np.empty((b, w), np.int32)
    tw = np.empty((b, w), np.int32)
    rows64 = [SelectedTerms(np.arange(w), np.arange(w)) for _ in range(b)]
    assert not native.stack_rows(rows64, "token_ids", "weights", ti, tw)
    short = [SelectedTerms(np.arange(w - 1, dtype=np.int32),
                           np.arange(w - 1, dtype=np.int32))
             for _ in range(b)]
    assert not native.stack_rows(short, "token_ids", "weights", ti, tw)


def _index(seed, terms, n, k):
    rng = np.random.default_rng(seed)
    return rng, ImpactIndex.from_packed_arrays(
        rng.integers(0, terms, (n, k)).astype(np.int32),
        rng.integers(1, 50, (n, k)).astype(np.float32),
        term_keys=range(terms), device="cpu")


def _numpy_encode(monkeypatch, idx, rows, **kw):
    with monkeypatch.context() as m:
        m.setattr(impact_mod, "_hostops", _Refusing)
        return idx.encode_query_terms(rows, **kw)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_encode_query_terms_equals_the_numpy_body(monkeypatch, dtype):
    """int32 rows take the fused C encode, int64 rows (which both C helpers
    refuse) the numpy body: the arrays are the numpy body's either way."""
    rng, idx = _index(2, 200, 30, 8)
    rows = [SelectedTerms(rng.integers(0, 400, 12).astype(dtype),
                          rng.integers(-3, 40, 12).astype(dtype))
            for _ in range(20)]
    hostops.reset_call_counts()
    got = idx.encode_query_terms(rows)
    counts = hostops.call_counts()
    # int64 rows: both helpers refuse them, which counts no call
    assert counts["encode_terms"] == (1 if dtype is np.int32 else 0)
    assert counts["stack_rows"] == 0
    want = _numpy_encode(monkeypatch, idx, rows)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype


def test_encode_terms_qmax_and_canonical_parity(monkeypatch):
    """Bit-equal to the numpy body under q_max pad widening; a
    canonical_map takes the C row stack and numpy's merge."""
    rng, idx = _index(3, 150, 25, 6)
    rows = [SelectedTerms(rng.integers(-5, 190, 10).astype(np.int32),
                          rng.integers(-2, 25, 10).astype(np.int32))
            for _ in range(12)]
    canon = np.arange(190, dtype=np.int64)
    canon[75] = 50                               # fold one id into another
    for kwargs in ({"q_max": 130}, {"canonical_map": canon},
                   {"q_max": 130, "canonical_map": canon}):
        hostops.reset_call_counts()
        got = idx.encode_query_terms(rows, **kwargs)
        counts = hostops.call_counts()
        canonical = "canonical_map" in kwargs
        assert counts["encode_terms"] == (0 if canonical else 1)
        assert counts["stack_rows"] == (1 if canonical else 0)
        want = _numpy_encode(monkeypatch, idx, rows, **kwargs)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        if "q_max" in kwargs:
            assert got[0].shape[1] >= 130 and got[0].shape[1] % 64 == 0


def test_encode_terms_adversarial_inputs(native, jnative):
    """Straight at the C op, both packages': extreme and negative ids
    against a tiny lut, the pad region zero-filled over poisoned buffers,
    wrong-width rows, int64 rows and too-small outputs refused, a missing
    attribute raises."""

    class Row:
        def __init__(self, i, w):
            self.token_ids, self.weights = i, w

    lut = np.array([3], np.int32)
    rows = [Row(np.array([0, -1, 2**31 - 1, 5], np.int32),
                np.array([1, 1, 1, 0], np.int32))]
    for ext in (native, jnative):
        oi = np.full((1, 64), -9, np.int32)
        ow = np.full((1, 64), -9.0, np.float32)
        assert ext.encode_terms(rows, "token_ids", "weights", lut, 4, oi, ow)
        assert oi[0, :4].tolist() == [3, 0, 0, 0]
        assert ow[0, :4].tolist() == [1.0, 0.0, 0.0, 0.0]
        assert (oi[0, 4:] == 0).all() and (ow[0, 4:] == 0).all()
        bad = [Row(np.array([0], np.int32), np.array([1], np.int32))]
        assert not ext.encode_terms(bad, "token_ids", "weights", lut, 4,
                                    oi, ow)
        r64 = [Row(np.arange(4, dtype=np.int64), np.ones(4, np.int64))]
        assert not ext.encode_terms(r64, "token_ids", "weights", lut, 4,
                                    oi, ow)
        small = np.zeros((1, 2), np.int32), np.zeros((1, 2), np.float32)
        assert not ext.encode_terms(rows, "token_ids", "weights", lut, 4,
                                    *small)

        class NoAttr:
            pass

        with pytest.raises(AttributeError):
            ext.encode_terms([NoAttr()], "token_ids", "weights", lut, 4,
                             oi, ow)


def _rand_run(rng, n_q, present=1.0, int_scores=False, flat=False):
    run = {}
    for q in range(n_q):
        if rng.random() > present:
            continue
        docs = {}
        for d in rng.sample(range(40), rng.randint(0, 12)):
            docs[f"d{d}"] = rng.randint(0, 500) if int_scores else \
                rng.uniform(-3, 9)
        vals = list(docs.values())
        if flat and vals:                  # zero range: 1e-9 denominator
            docs = {k: vals[0] for k in docs}
            vals = list(docs.values())
        run[f"q{q}"] = {"docs": docs,
                        "min_score": float(min(vals)) if vals else 0.0,
                        "max_score": float(max(vals)) if vals else 0.0}
    return run


def test_fuse_runs_bit_equal_to_python_and_jax(native):
    """Overlapping and disjoint docs, asymmetric qids, int scores, zero
    ranges, a negative weight, three runs, an empty run: the same doubles
    as the Python body and the JAX package's ``fuse``."""
    rng = random.Random(7)
    cases = [
        ([_rand_run(rng, 10), _rand_run(rng, 10)], [0.3, 0.7]),
        ([_rand_run(rng, 8, 0.6), _rand_run(rng, 8, 0.7)], [0.5, 0.5]),
        ([_rand_run(rng, 6, int_scores=True), _rand_run(rng, 6)],
         [1.0, -0.25]),
        ([_rand_run(rng, 5, flat=True), _rand_run(rng, 5)], [0.4, 0.6]),
        ([_rand_run(rng, 4), _rand_run(rng, 4), _rand_run(rng, 4, 0.5)],
         [0.2, 0.3, 0.5]),
        ([_rand_run(rng, 3), {}], [0.9, 0.1]),
    ]
    for runs, weights in cases:
        hostops.reset_call_counts()
        got = fuse(runs, weights)
        assert hostops.call_counts()["fuse_runs"] == 1
        want = fusion_mod._fuse_python(runs, weights)
        ref = jfuse(runs, weights)
        assert set(got) == set(want) == set(ref)
        for qid in want:
            assert got[qid] == want[qid] == ref[qid], qid
    # a malformed entry raises TypeError in C; fuse takes the Python body
    # and fails as that body does
    bad = [{"q0": {"docs": "not-a-dict", "min_score": 0.0,
                   "max_score": 1.0}}]
    with pytest.raises(TypeError):
        native.fuse_runs(bad, [1.0])
    with pytest.raises(TypeError):
        fusion_mod._fuse_python(bad, [1.0])
    with pytest.raises(TypeError):
        fuse(bad, [1.0])


class _Seg:
    def __init__(self, tombstones, n_pad):
        self.tombstones = tombstones
        self.n_pad = n_pad


def _segments(seed, pad_id, n_seg=4, b=12):
    rng = np.random.default_rng(seed)
    per_segment, segments = [], []
    for s in range(n_seg):
        scores, ids = [], []
        for _ in range(b):
            m = int(rng.integers(0, 9))
            # integer scores force ties across and within segments
            scores.append([float(x) for x in rng.integers(0, 6, m)])
            ids.append([f"s{s}d{rng.integers(0, 30)}" for _ in range(m)]
                       + ([pad_id] if m and s % 2 else []))
            if m and s % 2:                  # the pad entry's score
                scores[-1].append(float(rng.integers(0, 6)))
        per_segment.append((scores, ids))
        segments.append(_Seg({f"s{s}d{j}" for j in rng.integers(0, 30, 4)},
                             1 if s % 2 else 0))
    return per_segment, segments


def test_merge_topk_rows_bit_equal_to_python_and_jax(jnative):
    """Ragged rows with ties (stable order), tombstones and pads: the C
    merge equals the Python body and the JAX extension, exact floats and
    order; tuple rows take the Python body."""
    assert live_mod._PAD_ID == jlive._PAD_ID
    per_segment, segments = _segments(0, live_mod._PAD_ID)
    tombs = [s.tombstones for s in segments]
    pads = [1 if s.n_pad else 0 for s in segments]
    hostops.reset_call_counts()
    got = live_mod._merge_rows(per_segment, segments, 6)
    assert hostops.call_counts()["merge_topk_rows"] == 1
    want = live_mod._merge_rows_python(per_segment, tombs, pads, 6)
    ref = jnative.merge_topk_rows([p[0] for p in per_segment],
                                  [p[1] for p in per_segment], tombs, pads,
                                  jlive._PAD_ID, 6)
    assert got[0] == want[0] == ref[0]
    assert got[1] == want[1] == ref[1]
    as_tuples = [(tuple(s), tuple(i)) for s, i in per_segment]
    hostops.reset_call_counts()
    assert live_mod._merge_rows(as_tuples, segments, 6) == want
    assert hostops.call_counts()["merge_topk_rows"] == 0


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a compiler that fails, or a missing ``Python.h``, makes
    the build raise; it leaves no file in the build directory."""
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed to build"):
        hostops.build()
    build_dir = hostops.SOURCE.parent / "build"
    assert not hostops.library_path().exists()
    assert list(build_dir.glob(f"*.{os.getpid()}.tmp.so")) == []
    monkeypatch.setattr(hostops, "include_dir", lambda: str(tmp_path))
    with pytest.raises(RuntimeError, match="Python.h"):
        hostops.build()
    monkeypatch.setattr(hostops, "_module", None)
    with pytest.raises(RuntimeError, match="Python.h"):
        hostops.get()


def test_library_name_tracks_source_and_flags(monkeypatch):
    so = hostops.library_path()
    assert so.parent == hostops.SOURCE.parent / "build"
    assert so.suffix == ".so"
    assert hostops.get().path == so and so.exists()
    monkeypatch.setattr(hostops, "CXX_FLAGS", ("-O3", "-fPIC", "-shared"))
    assert hostops.library_path() != so

"""PyTorch port, the ``compact48`` wire: ``ops/packing.pack_topk48`` /
``unpack_topk48``, the score programs ``_taat_topk48`` / ``_impact_topk48``
with and without a doc mask, ``ImpactIndex(wire="compact48")`` with its
guards and its int16 query upload, and ``RetrievalService(wire=...)``,
against the JAX package on the same seeded inputs.

Tolerance: exact. The wire carries integer scores below 2^24 and doc
positions below 2^23 in three uint16 lanes, so the port's lanes equal the
JAX package's byte for byte on the same (score, id) input. Search results
are integer impact sums, exact on both sides; they compare as (score, id)
sets, up to docs tied at the depth cut (``torch.topk`` and ``lax.top_k``
keep different docs of a tie).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mllm_sparse_retrieval_tpu.index.filter import DocFilter as JDocFilter
from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpactIndex
from mllm_sparse_retrieval_tpu.ops import packing as jpacking
from mllm_sparse_retrieval_tpu.ops import score_programs as JSP
from mllm_sparse_retrieval_tpu.serving.service import (
    RetrievalService as JRetrievalService)
from mllm_sparse_retrieval_tpu_torch.index import DocFilter, ImpactIndex
from mllm_sparse_retrieval_tpu_torch.index import impact as impact_mod
from mllm_sparse_retrieval_tpu_torch.ops import packing
from mllm_sparse_retrieval_tpu_torch.ops import score_programs as SP
from mllm_sparse_retrieval_tpu_torch.serving import RetrievalService
from tests.torch_threads import one_torch_thread  # noqa: F401

N_DOCS, N_TERMS, DOC_K, B, Q = 300, 60, 8, 8, 64


def _boundary_lanes():
    """The JAX package's pack48 boundary values (tests/test_packing.py)."""
    rng = np.random.default_rng(3)
    scores = rng.integers(0, 2 ** 24, size=(16, 10)).astype(np.float32)
    scores[0, 0] = 0.0
    scores[0, 1] = 2 ** 24 - 1          # top of the 24-bit lane
    scores[0, 2] = 65535.0              # lo-lane boundary
    scores[0, 3] = 65536.0              # first hi-lane bit
    scores[0, 4] = 2.0 ** 25            # clamps to 2^24 - 1
    scores[1, :] = -np.inf              # masked rows clamp to 0
    idx = rng.integers(0, 2 ** 23, size=(16, 10)).astype(np.int32)
    idx[2, 0] = 0
    idx[2, 1] = 2 ** 23 - 1
    idx[2, 2] = 65535
    idx[2, 3] = 65536
    return scores, idx


def test_pack48_round_trip_and_bytes_equal_jax():
    scores, idx = _boundary_lanes()
    mine = packing.pack_topk48(torch.from_numpy(scores),
                               torch.from_numpy(idx)).numpy()
    theirs = np.asarray(jpacking.pack_topk48(jnp.asarray(scores),
                                             jnp.asarray(idx)))
    assert mine.shape == theirs.shape == (16, 30)
    assert theirs.dtype == np.uint16 and mine.dtype == np.int16
    assert mine.tobytes() == theirs.tobytes()
    s2, i2 = packing.unpack_topk48(mine)
    expect = np.clip(np.where(np.isfinite(scores), scores, 0.0), 0,
                     2 ** 24 - 1)
    np.testing.assert_array_equal(s2, expect)
    np.testing.assert_array_equal(i2, idx)
    assert s2.dtype == np.float32
    # each package's unpacker reads the other's lanes
    for a, b in zip(packing.unpack_topk48(theirs),
                    jpacking.unpack_topk48(mine.view(np.uint16))):
        np.testing.assert_array_equal(a, b)


def _corpus(seed=0, n_docs=N_DOCS, n_terms=N_TERMS, hi=350):
    rng = np.random.default_rng(seed)
    doc_t = np.argsort(rng.random((n_docs, n_terms)), axis=1)[:, :DOC_K]
    doc_t = doc_t.astype(np.int32)      # distinct terms in each doc
    doc_w = rng.integers(1, hi, size=(n_docs, DOC_K)).astype(np.float32)
    q_i = rng.integers(0, n_terms, size=(B, Q)).astype(np.int32)
    q_w = rng.integers(-5, 300, size=(B, Q)).astype(np.float32)
    q_w[:, -9:] = 0                    # padding slots
    q_w[5] = 0                         # an empty query
    return doc_t, doc_w, q_i, q_w


def _pair(doc_t, doc_w, n_terms=N_TERMS):
    ids = [f"d{i}" for i in range(doc_t.shape[0])]
    return (ImpactIndex.from_packed_arrays(doc_t, doc_w, ids, range(n_terms),
                                           device="cpu"),
            JImpactIndex.from_packed_arrays(doc_t, doc_w, ids,
                                            range(n_terms)))


def _positive_sets(scores, idx):
    """Per row: the (score, doc) pairs with a positive score, and the
    multiset of all scores (tie order apart, the top-k is these)."""
    return [({(float(s), int(i)) for s, i in zip(sr, ir) if s > 0},
             sorted(sr.tolist())) for sr, ir in zip(scores, idx)]


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("backend", ["taat", "matmul"])
def test_topk48_programs_match_jax(backend, filtered):
    doc_t, doc_w, q_i, q_w = _corpus()
    port, ref = _pair(doc_t, doc_w)
    allow = np.zeros(N_DOCS, bool)
    allow[::3] = True
    if backend == "taat":
        mat = port._materialize("i16")
        jmat = ref._materialize(None, "i16", kernel_layout=True)
        fn, jfn, jfn_f = SP._taat_topk48, JSP._taat_topk48, \
            JSP._taat_topk48_filtered
    else:
        mat = port._materialize("f32")
        jmat = ref._materialize(None, "f32")
        fn, jfn, jfn_f = SP._impact_topk48, JSP._impact_topk48, \
            JSP._impact_topk48_filtered
    n_pad, jn_pad = mat.shape[1], int(np.prod(jmat.shape[1:]))
    for k in (N_DOCS, 10):            # every doc, then a cut with ties
        mask = jmask = None
        if filtered:
            mask = DocFilter(allow).device_mask(n_pad, "cpu")
            jmask = JDocFilter(allow).device_mask(jn_pad)
        got = fn(mat, torch.from_numpy(q_i), torch.from_numpy(q_w), N_DOCS,
                 k, mask)
        if filtered:
            want = jfn_f(jmat, q_i, q_w, jmask, N_DOCS, k)
        else:
            want = jfn(jmat, q_i, q_w, N_DOCS, k)
        assert got.dtype == torch.int16 and got.shape == (B, 3 * k)
        g = packing.unpack_topk48(got.numpy())
        w = jpacking.unpack_topk48(np.asarray(want))
        g_sets, w_sets = _positive_sets(*g), _positive_sets(*w)
        for (gs, gall), (ws, wall) in zip(g_sets, w_sets):
            assert gall == wall
            if k == N_DOCS:
                assert gs == ws
            else:
                cut = min(s for s in gall)
                assert {x for x in gs if x[0] > cut} == \
                    {x for x in ws if x[0] > cut}
            if filtered:
                assert all(allow[d] for _, d in gs)
        # the same lanes as packing the program's own i32 top-k
        i32 = (SP._taat_topk if backend == "taat" else SP._impact_topk)(
            mat, torch.from_numpy(q_i), torch.from_numpy(q_w), N_DOCS, k,
            mask)
        s32, id32 = packing.unpack_topk(i32.numpy())
        # (the i32 wire keeps a filtered -inf, the compact wire clamps it)
        assert [x[0] for x in _positive_sets(s32, id32)] == \
            [x[0] for x in g_sets]


def _sets(scores, ids):
    return [{(float(s), str(i)) for s, i in zip(sr, ir)}
            for sr, ir in zip(scores, ids)]


@pytest.mark.parametrize("backend", ["taat", "matmul"])
def test_index_compact48_equals_i32_and_jax(backend):
    """70,000 docs of integer weights: scores above 2^16 and doc positions
    above 2^16 take both hi lanes (the JAX package's wire test corpus);
    depth 25 keeps ties at the cut out of the comparison only where the
    sets are compared up to the cut score."""
    rng = np.random.default_rng(11)
    n_docs, n_terms = 70_000, 40
    # distinct terms in each doc (a repeated (doc, term) pair is scattered
    # last-write-wins, and the two packages may keep different writes)
    doc_t = np.argsort(rng.random((n_docs, n_terms)), axis=1)[:, :4].astype(
        np.int32)
    doc_w = rng.integers(1, 300, size=(n_docs, 4)).astype(np.float32)
    port, ref = _pair(doc_t, doc_w, n_terms)
    q_i = rng.integers(0, n_terms, size=(32, 6)).astype(np.int32)
    q_w = rng.integers(1, 300, size=(32, 6)).astype(np.float32)
    q_w[3, 1:] = 0
    a = port.search_encoded(q_i, q_w, 25, backend=backend)
    b = port.search_encoded(q_i, q_w, 25, backend=backend, wire="compact48")
    j = ref.search_encoded(q_i, q_w, 25, backend="matmul", wire="compact48")
    assert a[0] == b[0] == j[0]          # rank-wise scores, exactly
    for sa, ra, rb, rj in zip(a[0], a[1], b[1], j[1]):
        cut = sa[-1]
        above = {(s, d) for s, d in zip(sa, ra) if s > cut}
        for other in (rb, rj):
            assert {(s, d) for s, d in zip(sa, other) if s > cut} == above
    assert max(max(r) for r in a[0]) > 65536
    assert any(int(d[1:]) >= 65536 for row in b[1] for d in row)


@pytest.mark.parametrize("backend", ["taat", "matmul"])
def test_filtered_compact48_matches_jax(backend):
    doc_t, doc_w, q_i, q_w = _corpus(1)
    port, ref = _pair(doc_t, doc_w)
    keep = [f"d{i}" for i in range(0, N_DOCS, 7)]
    flt = DocFilter.from_ids(port.doc_ids, keep)
    jflt = JDocFilter.from_ids(ref.doc_ids, keep)
    got = port.search_encoded(q_i, q_w, N_DOCS, backend=backend,
                              wire="compact48", doc_filter=flt)
    i32 = port.search_encoded(q_i, q_w, N_DOCS, backend=backend,
                              doc_filter=flt)
    want = ref.search_encoded(q_i, q_w, N_DOCS, backend="matmul",
                              wire="compact48", doc_filter=jflt)
    assert _sets(*got) == _sets(*i32) == _sets(*want)
    assert got[0][5] == [] and all(d in set(keep) for r in got[1] for d in r)
    assert max(len(r) for r in got[1]) <= len(keep)


def test_compact48_wire_guards():
    """The JAX package's guards (tests/test_impact_index.py): fractional
    query or doc weights, an unknown wire, a batch whose score bound
    reaches 2^24, and a padded corpus of 2^23 doc columns."""
    rng = np.random.default_rng(12)
    doc_t = rng.integers(0, 20, size=(50, 3)).astype(np.int32)
    doc_w = rng.integers(1, 90, size=(50, 3)).astype(np.float32)
    port, ref = _pair(doc_t, doc_w, 20)
    q_i = rng.integers(0, 20, size=(4, 3)).astype(np.int32)
    q_w = rng.integers(1, 50, size=(4, 3)).astype(np.float32)
    top = float(doc_w.max())
    big = np.full((4, 3), np.ceil(2.0 ** 24 / top / 3) + 1, np.float32)
    frac_p, frac_j = _pair(doc_t, doc_w + 0.5, 20)
    cases = [((q_i, q_w + 0.5, "compact48"), "integer query weights"),
             ((q_i, q_w, "zstd"), "unknown wire"),
             ((q_i, big, "compact48"), "cannot prove scores < 2")]
    for index in (port, ref):
        for (qi, qw, wire), match in cases:
            with pytest.raises(ValueError, match=match):
                index.search_encoded(qi, qw, 5, backend="matmul", wire=wire)
    for index in (frac_p, frac_j):
        with pytest.raises(ValueError, match="integer doc weights"):
            index.search_encoded(q_i, q_w, 5, backend="matmul",
                                 wire="compact48")
    # just under the bound passes, with the same results as the i32 wire
    under = np.full((4, 3), np.floor((2 ** 24 - 1) / top / 3), np.float32)
    assert port.search_encoded(q_i, under, 5, backend="matmul",
                               wire="compact48") == \
        port.search_encoded(q_i, under, 5, backend="matmul")
    # the doc-position lane: a padded corpus of 2^23 columns is refused
    small = ImpactIndex.from_packed_arrays(
        np.zeros((2, 1), np.int32), np.ones((2, 1), np.float32),
        device="cpu")
    old = impact_mod._DOC_TILE
    impact_mod._DOC_TILE = 2 ** 23
    try:
        with pytest.raises(ValueError, match="2\\^23 doc columns"):
            small.search_encoded(np.zeros((1, 1), np.int32),
                                 np.ones((1, 1), np.float32), 1,
                                 backend="taat", wire="compact48")
    finally:
        impact_mod._DOC_TILE = old


def test_int16_upload_matches_jax_and_changes_no_result(monkeypatch):
    doc_t, doc_w, q_i, q_w = _corpus(2)
    port, ref = _pair(doc_t, doc_w)
    got = port._compact_queries(q_i, q_w)
    want = ref._compact_queries(q_i, q_w)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int16
        np.testing.assert_array_equal(a, b)
    for qw in (q_w + 0.25, np.where(q_w > 0, 40000.0, 0.0).astype(
            np.float32)):
        assert port._compact_queries(q_i, qw) is None
        assert ref._compact_queries(q_i, qw) is None
    assert port._compact_queries(q_i[:0], q_w[:0]) is None
    seen = []
    real = SP._taat_scores

    def spy(matrix, qi, qw):
        seen.append((qi.dtype, qw.dtype))
        return real(matrix, qi, qw)

    monkeypatch.setattr(SP, "_taat_scores", spy)
    for wire in ("i32", "compact48"):
        compact = port.search_encoded(q_i, q_w, 20, backend="taat",
                                      wire=wire)
        with monkeypatch.context() as m:
            m.setattr(port, "_compact_queries", lambda *a: None)
            wide = port.search_encoded(q_i, q_w, 20, backend="taat",
                                       wire=wire)
        assert _sets(*compact) == _sets(*wide)
    assert seen == [(torch.int16, torch.int16),
                    (torch.int32, torch.float32)] * 2


def _terms_requests(seed, n):
    rng = np.random.default_rng(seed)
    return [{int(t): int(w) for t, w in zip(
        rng.integers(0, N_TERMS, size=12), rng.integers(1, 250, size=12))}
        for _ in range(n)]


def test_service_compact48_matches_i32_and_jax():
    """Sparse serving on either wire, and a filtered share: every result
    equal to the i32 service's and to the JAX package's compact48 service
    (depth 300 keeps every matching doc, so no tie is cut)."""
    doc_t, doc_w, _, _ = _corpus(3)
    port, ref = _pair(doc_t, doc_w)
    reqs = _terms_requests(4, 12)
    keep = [f"d{i}" for i in range(0, N_DOCS, 5)]
    kw = dict(backend="taat", max_batch=4, depth_levels=(N_DOCS,),
              max_wait_ms=1.0, filters={"fifth": keep})
    out = {}
    services = {"c48": RetrievalService(impact_index=port, wire="compact48",
                                        **kw),
                "i32": RetrievalService(impact_index=port, **kw),
                "jax": JRetrievalService(impact_index=ref, wire="compact48",
                                         **dict(kw, backend="matmul"))}
    try:
        for name, svc in services.items():
            out[name] = [sorted(svc.search(terms=r, depth=N_DOCS,
                                           filter=f, timeout=60))
                         for f in (None, "fifth") for r in reqs]
    finally:
        for svc in services.values():
            svc.close()
    assert out["c48"] == out["i32"] == out["jax"]
    assert all(d in set(keep) for row in out["c48"][len(reqs):]
               for d, _ in row)
    with pytest.raises(ValueError, match="unknown wire"):
        RetrievalService(impact_index=port, wire="zstd")

"""PyTorch port: document filters (``index/filter.py``, the filtered score
programs and MIPS, ``ImpactIndex.search_encoded(doc_filter=...)``,
``DenseFlatIndex.search_ids(doc_filter=...)``) against the JAX package's
on the same numpy-seeded corpus, and against a sub-index that holds only
the allowed docs.

Tolerances: impact scores (integer weights) exact; dense scores (integer
vectors, so exact in f32 and bf16 too) exact. Rows compare as (doc, score)
sets, except for docs tied at the depth cut (tie order is not part of the
contract): the score lists are equal and every doc above the cut is in
both.
"""

import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.index import DenseFlatIndex as JDenseFlatIndex
from mllm_sparse_retrieval_tpu.index import DocFilter as JDocFilter
from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpactIndex
from mllm_sparse_retrieval_tpu_torch.index import (
    DenseFlatIndex, DocFilter, ImpactIndex)
from mllm_sparse_retrieval_tpu_torch.ops import score_programs as SP
from mllm_sparse_retrieval_tpu_torch.ops.packing import unpack_topk

DEPTH = 10


def _same_rows(got, want, depth=DEPTH):
    """Ragged (scores, ids) rows equal up to docs tied at the depth cut."""
    (g_s, g_i), (w_s, w_i) = got, want
    assert len(g_s) == len(w_s)
    for gs, gi, ws, wi in zip(g_s, g_i, w_s, w_i):
        assert len(gs) == len(gi) and len(ws) == len(wi)
        assert sorted(map(float, gs)) == sorted(map(float, ws))
        g = set(zip(gi, map(float, gs)))
        w = set(zip(wi, map(float, ws)))
        if len(gs) < depth:
            assert g == w
        else:
            cut = min(map(float, gs))
            assert {p for p in g if p[1] > cut} == {p for p in w if p[1] > cut}


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    ids = [f"d{i}" for i in range(60)]
    sparse = {i: {int(t): int(rng.integers(1, 30))
                  for t in rng.choice(40, 5, replace=False)} for i in ids}
    reps = dict(zip(ids, rng.integers(-9, 10, size=(60, 16))
                    .astype(np.float32)))
    allowed = [f"d{i}" for i in range(0, 60, 3)]          # every third doc
    terms = [{int(t): float(rng.integers(1, 9))
              for t in rng.choice(40, 4, replace=False)} for _ in range(7)]
    denses = rng.integers(-9, 10, size=(7, 16)).astype(np.float32)
    return ids, sparse, reps, allowed, terms, denses


def _impact(cls, docs, **kw):
    idx = cls(**kw)
    idx.add_many(sorted(docs.items()))
    idx.finalize()
    return idx


def _dense(cls, reps, **kw):
    idx = cls(**kw)
    ids = sorted(reps)
    idx.add(np.stack([reps[i] for i in ids]), ids)
    return idx


def _search(index, terms, backend, doc_filter=None):
    q_idx, q_w = index.encode_queries(terms)
    return index.search_encoded(q_idx, q_w, DEPTH, backend=backend,
                                doc_filter=doc_filter)


@pytest.mark.parametrize("mode", ["allow", "deny"])
@pytest.mark.parametrize("backend", ["taat", "matmul"])
def test_impact_filter_matches_subindex_and_jax(corpus, backend, mode):
    ids, sparse, _, allowed, terms, _ = corpus
    full = _impact(ImpactIndex, sparse, device="cpu")
    kept = allowed if mode == "allow" else \
        [i for i in ids if i not in set(allowed)]
    sub = _impact(ImpactIndex, {i: sparse[i] for i in kept}, device="cpu")
    filt = DocFilter.from_ids(full.doc_ids, allowed, mode)
    assert filt.n_allowed == len(kept)
    got = _search(full, terms, backend, filt)
    assert full.search(terms, DEPTH, backend, doc_filter=filt) == got
    for s_row, i_row in zip(*got):
        assert set(i_row) <= set(kept) and all(s > 0 for s in s_row)
    _same_rows(got, _search(sub, terms, backend))
    jfull = _impact(JImpactIndex, sparse)
    jfilt = JDocFilter.from_ids(jfull.doc_ids, allowed, mode)
    np.testing.assert_array_equal(filt.mask, jfilt.mask)
    _same_rows(got, jfull.search(terms, DEPTH, backend="matmul",
                                 doc_filter=jfilt))
    # the unfiltered scores of the allowed docs, exactly
    deep_s, deep_i = full.search_encoded(*full.encode_queries(terms),
                                         len(ids), backend=backend)
    for gs, gi, ds, di in zip(*got, deep_s, deep_i):
        score_of = dict(zip(di, ds))
        assert all(score_of[d] == s for d, s in zip(gi, gs))


def test_filtered_score_programs_agree_and_skip_padding():
    rng = np.random.default_rng(3)
    t, n_pad, n_valid, b, q = 30, 2048, 1500, 5, 8
    matrix = torch.zeros((t + 1, n_pad))
    matrix[1:, :n_valid] = torch.from_numpy(
        rng.integers(0, 20, size=(t, n_valid)).astype(np.float32))
    q_idx = torch.from_numpy(rng.integers(0, t, size=(b, q)).astype(np.int32))
    q_w = torch.from_numpy(rng.integers(0, 5, size=(b, q)).astype(np.float32))
    mask = torch.from_numpy(rng.random(n_pad) < 0.2)
    mask[n_valid:] = True       # padding columns stay out all the same
    for k in (10, 400):
        a = SP._taat_topk(matrix, q_idx, q_w, n_valid, k, mask)
        m = SP._impact_topk(matrix, q_idx, q_w, n_valid, k, mask)
        (sa, ia), (sm, im) = unpack_topk(a.numpy()), unpack_topk(m.numpy())
        np.testing.assert_array_equal(sa, sm)
        full = SP._scores_from_matrix(matrix, q_idx, q_w).numpy()
        allowed = mask.numpy()[:n_valid]
        for r in range(b):
            finite = np.isfinite(sa[r])
            assert allowed[ia[r][finite]].all() and (ia[r][finite] <
                                                     n_valid).all()
            np.testing.assert_array_equal(sa[r][finite],
                                          full[r, ia[r][finite]])
            ref = np.sort(np.where(allowed, full[r, :n_valid],
                                   -np.inf))[::-1][:k]
            np.testing.assert_array_equal(sa[r], ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_filter_matches_subindex_and_jax(corpus, dtype):
    import jax.numpy as jnp

    _, _, reps, allowed, _, denses = corpus
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    full = _dense(DenseFlatIndex, reps, dtype=tdt, device="cpu")
    sub = _dense(DenseFlatIndex, {i: reps[i] for i in allowed}, dtype=tdt,
                 device="cpu")
    filt = DocFilter.from_ids(full.lookup, allowed)
    got = full.search_ids(denses, DEPTH, batch_size=4, doc_filter=filt)
    assert isinstance(got[0], list)
    ref_s, ref_i = sub.search_ids(denses, DEPTH, batch_size=4)
    _same_rows(got, (ref_s.tolist(), ref_i))
    jfull = _dense(JDenseFlatIndex, reps, dtype=jdt)
    _same_rows(got, jfull.search_ids(
        denses, DEPTH, batch_size=4,
        doc_filter=JDocFilter.from_ids(jfull.lookup, allowed)))
    # search() keeps the -inf rows in place
    s, _ = full.search(denses, len(reps), doc_filter=filt)
    assert np.isinf(s).sum(axis=1).tolist() == [len(reps) - len(allowed)] * 7


def test_dense_filter_ragged_when_depth_exceeds_allowed(corpus):
    _, _, reps, _, _, denses = corpus
    full = _dense(DenseFlatIndex, reps, device="cpu")
    filt = DocFilter.from_ids(full.lookup, ["d1", "d2", "d3"])
    scores, ids = full.search_ids(denses[:2], DEPTH, doc_filter=filt)
    for s_row, i_row in zip(scores, ids):
        assert len(i_row) == len(s_row) == 3
        assert set(i_row) == {"d1", "d2", "d3"}
        assert all(np.isfinite(s) for s in s_row)


def test_doc_filter_validation_and_cache(corpus):
    ids = corpus[0]
    with pytest.raises(ValueError, match="bool"):
        DocFilter(np.ones(5, np.int32))
    with pytest.raises(ValueError, match="bool"):
        DocFilter(np.ones((2, 3), bool))
    with pytest.raises(ValueError, match="mode"):
        DocFilter.from_ids(ids, ["d1"], mode="nope")
    f = DocFilter.from_ids(ids, ["d1", "ghost"])
    assert f.n_allowed == 1 == JDocFilter.from_ids(ids, ["d1", "ghost"]) \
        .n_allowed                                 # unknown ids ignored
    m1 = f.device_mask(64, "cpu")
    assert f.device_mask(64, torch.device("cpu")) is m1   # cached
    assert f.device_mask(128, "cpu") is not m1
    assert m1.dtype == torch.bool and m1.shape == (64,)
    assert m1[:60].numpy().tolist() == f.mask.tolist() and not m1[60:].any()
    with pytest.raises(ValueError, match="padded"):
        f.device_mask(10, "cpu")

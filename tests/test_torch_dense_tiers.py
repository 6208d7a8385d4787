"""PyTorch port, the dense tiers beside the exact f32 / bf16 index: SQ8
(``DenseFlatIndex(dtype=torch.int8)``, ``ops/mips.mips_topk_packed_q8``)
and ANN (``index/ann.DenseANNIndex``, ``ops/ann.py``), against the JAX
package on the same seeded inputs.

Tolerances:

- ``_quantize_rows`` and ``ip_projection``: exact (the same numpy code).
- SQ8: exact. Both packages quantize the same f32 rows the same way, sum
  int8 products exactly in int32 and dequantize by the same f32 product of
  scales, so the scores are equal bit for bit; ids compare as sets up to
  docs tied at the cut. On integer rows whose absmax is 127 (scale 1) the
  scores also equal the f32 index's (the JAX package's construction).
- ANN: a returned score is the full-f32 rescore of its row, within ``1e-5``
  of the exact index's score and of the JAX package's; where every true
  top-k row is a candidate (full rank, or ``candidates >= N``) the ids are
  the exact index's, up to docs tied within ``1e-5`` at the cut.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.index.ann import DenseANNIndex as JANN
from mllm_sparse_retrieval_tpu.index.dense import (
    DenseFlatIndex as JDenseFlatIndex)
from mllm_sparse_retrieval_tpu.index.filter import DocFilter as JDocFilter
from mllm_sparse_retrieval_tpu.ops import ann as jann
from mllm_sparse_retrieval_tpu.ops import mips as jmips
from mllm_sparse_retrieval_tpu_torch.index import (
    DenseANNIndex, DenseFlatIndex, DocFilter)
from mllm_sparse_retrieval_tpu_torch.ops import ann, mips
from mllm_sparse_retrieval_tpu_torch.ops.packing import unpack_topk

N, D, B = 301, 37, 19          # N and D off the card's multiples of 8


def _gauss(rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _int_rows(rng, n, d=16):
    """Integer rows of absmax 127: scale 1, lossless quantization."""
    x = rng.integers(-127, 128, size=(n, d)).astype(np.float32)
    x[:, 0] = 127.0 * np.sign(x[:, 0] + 0.5)
    return x


def _same_up_to_ties(s, got_ids, want_s, want_ids, tol):
    """Rank-wise scores within ``tol``; docs above the cut (by 2 tol) in
    both rows."""
    s, want_s = np.asarray(s, np.float64), np.asarray(want_s, np.float64)
    np.testing.assert_allclose(s, want_s, rtol=0, atol=tol)
    for srow, grow, wrow in zip(s, got_ids, want_ids):
        cut = srow[-1] + 2 * tol
        assert {d for d, x in zip(grow, srow) if x > cut} <= set(wrow)


def test_quantize_rows_matches_jax():
    rng = np.random.default_rng(0)
    x = _gauss(rng, 40) * 3.0
    x[5] = 0.0                               # an all-zero row: scale 1
    x[6] = 1e-30
    got = DenseFlatIndex._quantize_rows(x)
    want = JDenseFlatIndex._quantize_rows(x)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[1][5] == 1.0 and not got[0][5].any()
    e = DenseFlatIndex._quantize_rows(x[:0])
    assert e[0].shape == (0, D) and e[1].shape == (0,)


@pytest.mark.parametrize("filtered", [False, True])
def test_q8_program_matches_jax_bit_for_bit(filtered):
    rng = np.random.default_rng(1)
    c8, cs = DenseFlatIndex._quantize_rows(_gauss(rng, N) * 2.0)
    q8, qs = DenseFlatIndex._quantize_rows(_gauss(rng, B))
    mask = rng.random(N) < 0.3
    k = 12
    got = mips.mips_topk_packed_q8(
        torch.from_numpy(q8), torch.from_numpy(qs), torch.from_numpy(c8),
        torch.from_numpy(cs), k, mask=torch.from_numpy(mask)
        if filtered else None)
    args = (jnp.asarray(q8), jnp.asarray(qs), jnp.asarray(c8),
            jnp.asarray(cs))
    want = jmips.mips_topk_packed_q8_filtered(*args, jnp.asarray(mask), k) \
        if filtered else jmips.mips_topk_packed_q8(*args, k)
    gs, gi = unpack_topk(got.numpy())
    ws, wi = unpack_topk(np.asarray(want))
    np.testing.assert_array_equal(gs, ws)
    for srow, grow, wrow in zip(gs, gi, wi):
        above = srow > srow[-1]
        assert set(grow[above]) == set(wrow[above])
        if filtered:
            assert mask[grow].all()
    # the int32 accumulators equal an int64 numpy product exactly
    acc = mips._int8_matmul(torch.from_numpy(q8), torch.from_numpy(c8))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(
        acc.numpy(), q8.astype(np.int64) @ c8.astype(np.int64).T)


@pytest.mark.parametrize("batch_size", [8, 19, 64])
def test_q8_index_matches_jax(batch_size):
    rng = np.random.default_rng(2)
    corpus, queries = _gauss(rng, N), _gauss(rng, B)
    ids = [f"d{i}" for i in range(N)]
    mine = DenseFlatIndex(dtype=torch.int8, device="cpu")
    mine.add(corpus[:100], ids[:100])
    mine.add(corpus[100:], ids[100:])
    theirs = JDenseFlatIndex(dtype=jnp.int8)
    theirs.add(corpus, ids)
    assert mine.q8 and mine.dtype == torch.int8
    s, i = mine.search_ids(queries, 15, batch_size=batch_size)
    js, ji = theirs.search_ids(queries, 15, batch_size=batch_size)
    np.testing.assert_array_equal(s, np.asarray(js))
    _same_up_to_ties(s, i, js, ji, 0.0)
    # padded to the card's multiples of 8; the padding rows never rank
    assert tuple(mine._corpus_dev.shape) == (304, 40)
    assert mine._corpus_dev.dtype == torch.int8
    keep = ids[::10]
    fs, fi = mine.search_ids(queries, 40, batch_size=batch_size,
                             doc_filter=DocFilter.from_ids(mine.lookup, keep))
    jfs, jfi = theirs.search_ids(
        queries, 40, batch_size=batch_size,
        doc_filter=JDocFilter.from_ids(theirs.lookup, keep))
    assert [len(r) for r in fi] == [len(r) for r in jfi] == [31] * B
    assert fs == jfs and [set(r) for r in fi] == [set(r) for r in jfi]
    assert {d for r in fi for d in r} <= set(keep)
    # "int8" spelled as a string, and a depth past the corpus
    alias = DenseFlatIndex(dtype="int8", device="cpu")
    alias.add(corpus[:5], ids[:5])
    s5, i5 = alias.search_ids(queries, 50)
    assert s5.shape == (B, 5) and all(sorted(r) == ids[:5] for r in i5)


def test_q8_index_on_integer_rows_equals_f32_and_jax():
    rng = np.random.default_rng(11)
    c, q = _int_rows(rng, 60), _int_rows(rng, 9)
    ids = [f"d{i}" for i in range(60)]
    scores = {}
    for name, index in (("f32", DenseFlatIndex(device="cpu")),
                        ("q8", DenseFlatIndex(dtype=torch.int8,
                                              device="cpu")),
                        ("jax", JDenseFlatIndex(dtype=jnp.int8))):
        index.add(c, ids)
        scores[name] = np.sort(np.asarray(index.search(q, depth=8)[0]),
                               axis=1)
    np.testing.assert_array_equal(scores["q8"], scores["f32"])
    np.testing.assert_array_equal(scores["q8"], scores["jax"])


@pytest.mark.parametrize("sample", [65536, 100])
def test_ip_projection_matches_jax(sample):
    rng = np.random.default_rng(3)
    x = _gauss(rng, N)
    got = ann.ip_projection(x, 8, sample=sample, seed=4)
    want = jann.ip_projection(x, 8, sample=sample, seed=4)
    assert got.dtype == np.float32 and got.shape == (D, 8)
    np.testing.assert_array_equal(got, want)
    assert ann.ip_projection(x, 500).shape == (D, D)


def _ann_pair(corpus, ids, **kw):
    mine = DenseANNIndex(device="cpu", **kw)
    theirs = JANN(**kw)
    mine.add(corpus, ids)
    theirs.add(corpus, ids)
    return mine, theirs


@pytest.mark.parametrize("kw", [dict(rank=D, candidates=40),
                                dict(rank=4, candidates=N)])
def test_ann_with_complete_candidates_equals_exact(kw):
    """Full rank keeps every inner product; ``candidates >= N`` rescored
    everything: the exact index's results, and the JAX package's."""
    rng = np.random.default_rng(5)
    corpus, queries = _gauss(rng, N), _gauss(rng, B)
    ids = [f"d{i}" for i in range(N)]
    exact = DenseFlatIndex(device="cpu")
    exact.add(corpus, ids)
    mine, theirs = _ann_pair(corpus, ids, **kw)
    es, ei = exact.search_ids(queries, 10, batch_size=8)
    s, i = mine.search_ids(queries, 10, batch_size=8)
    js, ji = theirs.search_ids(queries, 10, batch_size=8)
    _same_up_to_ties(s, i, es, ei, 1e-5)
    _same_up_to_ties(s, i, js, ji, 1e-5)
    ref = queries.astype(np.float64) @ corpus.astype(np.float64).T
    pos = {d: n for n, d in enumerate(ids)}
    for r, (srow, irow) in enumerate(zip(s, i)):
        np.testing.assert_allclose(srow, [ref[r, pos[d]] for d in irow],
                                   rtol=0, atol=1e-5)


def _low_rank(rng, n, d, true_rank, noise=0.02):
    """Rows near a ``true_rank``-dim subspace (tests/test_ann_index.py)."""
    u = rng.normal(size=(n, true_rank))
    basis = np.linalg.qr(rng.normal(size=(d, true_rank)))[0]
    return (u @ basis.T + noise * rng.normal(size=(n, d))).astype(np.float32)


def _recall(approx, exact, k):
    return sum(len(set(a[:k]) & set(e[:k]))
               for a, e in zip(approx, exact)) / (k * len(exact))


def test_ann_low_rank_recall_on_spectral_data():
    rng = np.random.default_rng(1)
    corpus = _low_rank(rng, 4000, 64, 12)
    queries = _low_rank(rng, 32, 64, 12)
    ids = [f"d{i}" for i in range(4000)]
    exact = DenseFlatIndex(device="cpu")
    exact.add(corpus, ids)
    mine, theirs = _ann_pair(corpus, ids, rank=16, candidates=128)
    _, ei = exact.search_ids(queries, 10, batch_size=16)
    s, i = mine.search_ids(queries, 10, batch_size=16)
    js, ji = theirs.search_ids(queries, 10, batch_size=16)
    assert _recall(i, ei, 10) >= 0.95
    assert abs(_recall(i, ei, 10) - _recall(ji, ei, 10)) <= 0.02
    pos = {d: n for n, d in enumerate(ids)}
    brute = queries.astype(np.float64) @ corpus.astype(np.float64).T
    for r, (srow, irow) in enumerate(zip(s, i)):
        np.testing.assert_allclose(srow, [brute[r, pos[d]] for d in irow],
                                   rtol=1e-5, atol=1e-5)
    # filtered: candidates come from allowed rows only
    keep = ids[::9]
    fs, fi = mine.search_ids(queries, 10, batch_size=16,
                             doc_filter=DocFilter.from_ids(mine.lookup, keep))
    jfs, jfi = theirs.search_ids(
        queries, 10, batch_size=16,
        doc_filter=JDocFilter.from_ids(theirs.lookup, keep))
    assert {d for r in fi for d in r} <= set(keep)
    assert [len(r) for r in fi] == [len(r) for r in jfi] == [10] * 32
    assert _recall(fi, jfi, 10) >= 0.95


def test_ann_clamps_candidates_and_add_invalidates_the_basis():
    rng = np.random.default_rng(2)
    small = DenseANNIndex(device="cpu", rank=4, candidates=4)
    small.add(rng.normal(size=(20, 8)).astype(np.float32),
              [f"d{i}" for i in range(20)])
    s, i = small.search_ids(rng.normal(size=(3, 8)).astype(np.float32), 12)
    assert s.shape == (3, 12) and all(len(set(r)) == 12 for r in i)
    grown = DenseANNIndex(device="cpu", rank=8, candidates=32)
    grown.add(rng.normal(size=(50, 16)).astype(np.float32),
              [f"a{i}" for i in range(50)])
    grown.search_ids(rng.normal(size=(2, 16)).astype(np.float32), 5)
    basis = grown._proj
    grown.add(np.full((1, 16), 9.0, np.float32), ["new"])
    assert grown._proj is None and grown._corpus_r_dev is None
    s, i = grown.search_ids(np.ones((1, 16), np.float32), 1)
    assert i[0] == ["new"] and grown._corpus_r_dev.shape == (51, 8)
    assert not np.array_equal(grown._proj, basis)


def test_ann_refuses_int8_and_takes_bf16():
    with pytest.raises(ValueError, match="int8"):
        DenseANNIndex(dtype=torch.int8, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        DenseANNIndex.from_flat(DenseFlatIndex(dtype="int8", device="cpu"))
    rng = np.random.default_rng(6)
    corpus, queries = _gauss(rng, N), _gauss(rng, B)
    ids = [f"d{i}" for i in range(N)]
    bf = DenseANNIndex(dtype=torch.bfloat16, device="cpu", rank=D,
                       candidates=64)
    bf.add(corpus, ids)
    exact = DenseFlatIndex(dtype=torch.bfloat16, device="cpu")
    exact.add(corpus, ids)
    s, i = bf.search_ids(queries, 10)
    es, ei = exact.search_ids(queries, 10)
    assert bf._corpus_dev.dtype == torch.bfloat16
    _same_up_to_ties(s, i, es, ei, 1e-5)


def test_artifacts_load_in_either_class_and_package(tmp_path):
    rng = np.random.default_rng(7)
    corpus, queries = _gauss(rng, N), _gauss(rng, B)
    ids = [f"d{i}" for i in range(N)]
    mine = DenseANNIndex(device="cpu", rank=D, candidates=64)
    mine.add(corpus, ids)
    mine.save_shard(str(tmp_path / "corpus_0.pkl"))
    with open(tmp_path / "corpus_0.pkl", "rb") as f:
        reps, lookup = pickle.load(f)
    assert reps.dtype == np.float32 and lookup == ids
    np.testing.assert_array_equal(reps, corpus)
    flat = DenseFlatIndex.load(str(tmp_path), device="cpu")
    again = DenseANNIndex.load(str(tmp_path), device="cpu")
    q8 = DenseFlatIndex.load(str(tmp_path), dtype=torch.int8, device="cpu")
    jflat = JDenseFlatIndex.load(str(tmp_path))
    assert type(again) is DenseANNIndex and again.lookup == ids
    assert q8.q8 and jflat.lookup == ids
    tiered = DenseANNIndex.from_flat(flat, rank=D, candidates=64)
    assert tiered.device == flat.device and tiered.lookup == flat.lookup
    assert flat._corpus_dev is None
    s, i = tiered.search_ids(queries, 10)
    fs, fi = flat.search_ids(queries, 10)
    _same_up_to_ties(s, i, fs, fi, 1e-5)
    q8.save_shard(str(tmp_path / "q8.pkl"))
    with open(tmp_path / "q8.pkl", "rb") as f:
        reps8, _ = pickle.load(f)
    assert reps8.dtype == np.float32             # pickles stay f32
    np.testing.assert_array_equal(reps8, corpus)

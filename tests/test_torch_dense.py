"""PyTorch port: ``ops/mips.py`` and ``index/dense.py::DenseFlatIndex``
against the JAX package's, in f32 and bf16, on seeded L2-normalized
vectors (some corpus rows duplicated, so exact ties occur).

Tolerances:

- f32: scores within ``1e-5`` of the JAX package's and of a float64 numpy
  product, ids equal up to docs tied (within the tolerance) at the cut.
- bf16: both packages round queries and corpus to bf16 (unit roundoff
  ``u = 2^-8``) and sum the exact products in f32. Against the float64
  product of the unrounded f32 vectors, a score may move by
  ``|q~.c~ - q.c| <= sum_i |q~_i c~_i - q_i c_i| <= (2u + u^2) sum_i |q_i c_i|``
  plus the f32 sum's ``d * 2^-24 * sum_i |q~_i c~_i|``; the port and the JAX
  package sum the same products in different orders, so they differ by at
  most twice that last term. The scores must be f32 (a bf16 output would
  round every score by up to ``2^-8 |s|``, far outside these bounds).
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.index.dense import (
    DenseFlatIndex as JDenseFlatIndex)
from mllm_sparse_retrieval_tpu.ops import mips as jmips
from mllm_sparse_retrieval_tpu_torch.index import DenseFlatIndex
from mllm_sparse_retrieval_tpu_torch.ops import mips

D, N, B = 64, 300, 37
U_BF16 = 2.0 ** -8
U_F32 = 2.0 ** -24


def _unit(rng, n):
    x = rng.standard_normal((n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    corpus = _unit(rng, N)
    corpus[7] = corpus[3]                       # exact ties
    corpus[200:205] = corpus[100]
    queries = _unit(rng, B)
    queries[5] = corpus[100]                    # a query on the tie block
    return queries, corpus


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy().astype(
        np.float64)


def _bounds(queries, corpus, dtype):
    """Per (query, doc) bound of |score - float64 score| for ``dtype``."""
    q, c = queries.astype(np.float64), corpus.astype(np.float64)
    if dtype == "f32":
        return np.full((q.shape[0], c.shape[0]), 1e-5)
    mag = np.abs(q) @ np.abs(c).T
    mag_r = np.abs(_bf16(queries)) @ np.abs(_bf16(corpus)).T
    return (2 * U_BF16 + U_BF16 ** 2) * mag + D * U_F32 * mag_r


def _check_topk(scores, idx, queries, corpus, k, dtype):
    """Each returned doc's score is within the bound of its float64 score,
    and the returned scores are the float64 top-k within the bound (so the
    ids are right up to docs tied within the bound at the cut)."""
    ref = queries.astype(np.float64) @ corpus.astype(np.float64).T
    bound = _bounds(queries, corpus, dtype)
    scores, idx = np.asarray(scores), np.asarray(idx)
    assert scores.dtype == np.float32
    assert scores.shape == idx.shape == (queries.shape[0], k)
    for r in range(queries.shape[0]):
        assert len(set(idx[r].tolist())) == k
        assert np.all(np.diff(scores[r]) <= 0)
        np.testing.assert_array_less(
            np.abs(scores[r] - ref[r, idx[r]]), bound[r, idx[r]] + 1e-12)
        top = np.sort(ref[r])[::-1][:k]
        assert np.all(np.abs(scores[r] - top) <= bound[r].max() + 1e-12)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 10, N + 50])
def test_mips_topk_matches_jax(data, dtype, k):
    queries, corpus = data
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    s, i = mips.mips_topk(torch.from_numpy(queries),
                          torch.from_numpy(corpus).to(tdt), k)
    kk = min(k, N)
    _check_topk(s.numpy(), i.numpy(), queries, corpus, kk, dtype)
    js, ji = jmips.mips_topk(jnp.asarray(queries, jdt),
                             jnp.asarray(corpus, jdt), k)
    _check_topk(np.asarray(js), np.asarray(ji), queries, corpus, kk, dtype)
    # port and JAX: the same products summed in another order
    tol = 1e-5 if dtype == "f32" else \
        2 * D * U_F32 * (np.abs(_bf16(queries)) @ np.abs(_bf16(corpus)).T
                         ).max()
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=tol)
    packed = mips.mips_topk_packed(torch.from_numpy(queries),
                                   torch.from_numpy(corpus).to(tdt), k)
    assert packed.dtype == torch.int32 and packed.shape == (B, 2 * kk)
    np.testing.assert_array_equal(packed[:, :kk].view(torch.float32), s)
    np.testing.assert_array_equal(packed[:, kk:], i)


def test_bf16_scores_are_f32_not_bf16(data):
    queries, corpus = data
    s = mips.mips_scores(torch.from_numpy(queries),
                         torch.from_numpy(corpus).to(torch.bfloat16))
    assert s.dtype == torch.float32
    exact = _bf16(queries) @ _bf16(corpus).T
    # f32 accumulation of exact products: far inside one bf16 ulp
    assert np.abs(s.numpy() - exact).max() <= D * U_F32
    rounded = torch.from_numpy(exact).to(torch.bfloat16).double().numpy()
    assert np.abs(rounded - exact).max() > 10 * D * U_F32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch_size", [8, 37, 128])
def test_dense_index_matches_jax(data, dtype, batch_size):
    queries, corpus = data
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ids = [f"d{i}" for i in range(N)]
    index = DenseFlatIndex(dtype=dtype, device="cpu")
    index.add(corpus[:120], ids[:120])
    index.add(corpus[120:], ids[120:])
    jindex = JDenseFlatIndex(dtype=jdt)
    jindex.add(corpus, ids)
    assert index.size == jindex.size == N and index.dim == D
    tag = "f32" if dtype == torch.float32 else "bf16"
    whole_s, whole_i = index.search(queries, 25)
    s, i = index.batch_search(queries, 25, batch_size=batch_size)
    _check_topk(s, i, queries, corpus, 25, tag)
    np.testing.assert_array_equal(s, whole_s)   # chunking changes nothing
    np.testing.assert_array_equal(i, whole_i)
    s_ids, id_rows = index.search_ids(queries, 25, batch_size=batch_size)
    js, jid_rows = jindex.search_ids(queries, 25, batch_size=batch_size)
    assert id_rows == [[ids[j] for j in row] for row in i.tolist()]
    tol = 1e-5 if tag == "f32" else 2 * D * U_F32
    np.testing.assert_allclose(s_ids, js, rtol=0, atol=tol)
    for r in range(B):
        cut = s_ids[r][-1] + 2 * _bounds(queries, corpus, tag)[r].max()
        above = {d for d, x in zip(id_rows[r], s_ids[r]) if x > cut}
        assert above <= set(jid_rows[r])


def test_depth_beyond_corpus_and_empty_query_batch(data):
    queries, corpus = data
    index = DenseFlatIndex(device="cpu")
    index.add(corpus[:9], list(range(9)))
    s, ids = index.search_ids(queries, 50, batch_size=16)
    jindex = JDenseFlatIndex()
    jindex.add(corpus[:9], list(range(9)))
    js, jids = jindex.search_ids(queries, 50, batch_size=16)
    assert s.shape == np.asarray(js).shape == (B, 9)
    assert [sorted(r) for r in ids] == [sorted(r) for r in jids] == \
        [[str(j) for j in range(9)]] * B
    np.testing.assert_allclose(s, js, rtol=0, atol=1e-5)
    s0, i0 = index.batch_search(queries[:0], 50)
    assert s0.shape == i0.shape == (0, 9)


def test_pickles_cross_load(data, tmp_path):
    queries, corpus = data
    ids = [f"d{i}" for i in range(N)]
    mine = DenseFlatIndex(device="cpu")
    mine.add(corpus[:100], ids[:100])
    theirs = JDenseFlatIndex()
    theirs.add(corpus[100:], ids[100:])
    mine.save_shard(str(tmp_path / "corpus_0.pkl"))
    theirs.save_shard(str(tmp_path / "corpus_1.pkl"))
    with open(tmp_path / "corpus_0.pkl", "rb") as f:
        reps, lookup = pickle.load(f)
    assert type(reps) is np.ndarray and reps.dtype == np.float32
    assert lookup == ids[:100]
    for dtype in (torch.float32, torch.bfloat16):
        both = DenseFlatIndex.load(str(tmp_path), dtype=dtype, device="cpu")
        assert both.lookup == ids and both.dtype == dtype
        np.testing.assert_array_equal(np.concatenate(both._chunks), corpus)
    jboth = JDenseFlatIndex.load(str(tmp_path))
    assert jboth.lookup == ids
    one = DenseFlatIndex.load(str(tmp_path / "corpus_1.pkl"), device="cpu")
    assert one.lookup == ids[100:]
    qdir = tmp_path / "q"
    qdir.mkdir()
    with open(qdir / "query.pkl", "wb") as f:
        pickle.dump((queries, [f"q{i}" for i in range(B)]), f)
    assert DenseFlatIndex.load(str(qdir), device="cpu").size == B
    with pytest.raises(FileNotFoundError):
        DenseFlatIndex.load(str(tmp_path / "q" / ".."  / "missing"),
                            device="cpu")


def test_dense_rejects_what_it_does_not_take(data):
    queries, corpus = data
    with pytest.raises(TypeError, match="float32, bfloat16 or int8"):
        DenseFlatIndex(dtype=torch.float16, device="cpu")
    with pytest.raises(TypeError, match="int8"):
        mips.mips_scores(torch.from_numpy(queries),
                         torch.zeros((4, D), dtype=torch.int8))
    index = DenseFlatIndex(device="cpu")
    with pytest.raises(ValueError, match=r"\[N, d\]"):
        index.add(corpus[0], ["x"])
    index.add(corpus[:3], ["a", "b", "c"])
    with pytest.raises(ValueError, match="dim mismatch"):
        index.add(corpus[:2, :10], ["d", "e"])
    with pytest.raises(ValueError, match="length mismatch"):
        index.add(corpus[:2], ["d"])

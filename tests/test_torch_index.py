"""PyTorch port, ``ImpactIndex``: build, search and persistence against the
JAX package on a small Zipf corpus (bench.py's distribution at smoke size).

Tolerance: exact. Integer impact weights make every score an exact f32
integer on both sides; results compare as (score, id) sets per query,
because equal-score ties may come out in any order.
"""

import numpy as np
import pytest

from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpactIndex
from mllm_sparse_retrieval_tpu.sparse.term_selection import (
    SelectedTerms as JSelectedTerms)
from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex
from mllm_sparse_retrieval_tpu_torch.sparse.term_selection import (
    SelectedTerms)

N_DOCS, N_TERMS, DOC_K, BATCH, Q = 300, 120, 12, 20, 9


def _zipf(rng, size):
    p = 1.0 / np.arange(1, N_TERMS + 1)
    return rng.choice(N_TERMS, size=size, p=p / p.sum())


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    doc_terms = _zipf(rng, (N_DOCS, DOC_K)).astype(np.int32)
    doc_weights = rng.integers(1, 350, size=(N_DOCS, DOC_K)).astype(
        np.float32)
    doc_weights[:, -2:] = 0             # padding entries
    ids = [f"d{i}" for i in range(N_DOCS)]
    q_terms = _zipf(rng, (BATCH, Q))
    q_w = rng.integers(-5, 300, size=(BATCH, Q))
    queries = [{int(t): int(w) for t, w in zip(tr, wr)}
               for tr, wr in zip(q_terms, q_w)]
    queries[3] = {}                     # an empty query
    queries[4] = {N_TERMS + 7: 50}      # out-of-vocabulary only
    return doc_terms, doc_weights, ids, queries


def _sets(scores, ids):
    return [{(float(s), str(i)) for s, i in zip(sr, ir)}
            for sr, ir in zip(scores, ids)]


@pytest.fixture(scope="module")
def indexes(corpus):
    doc_terms, doc_weights, ids, _ = corpus
    keys = range(N_TERMS)
    port = ImpactIndex.from_packed_arrays(doc_terms, doc_weights, ids, keys,
                                          device="cpu")
    ref = JImpactIndex.from_packed_arrays(doc_terms, doc_weights, ids, keys)
    return port, ref


@pytest.mark.parametrize("backend", ["taat", "matmul", "auto"])
@pytest.mark.parametrize("depth", [1, 10, 400])
def test_search_matches_jax_matmul(indexes, corpus, backend, depth):
    port, ref = indexes
    queries = corpus[3]
    q_idx, q_w = port.encode_queries(queries)
    r_idx, r_w = ref.encode_queries(queries)
    np.testing.assert_array_equal(q_idx, r_idx)
    np.testing.assert_array_equal(q_w, r_w)
    got = port.search_encoded(q_idx, q_w, depth, backend=backend)
    want = ref.search_encoded(r_idx, r_w, depth, backend="matmul")
    assert _sets(*got) == _sets(*want)
    assert got[0][3] == [] and got[0][4] == []
    for row in got[0]:
        assert row == sorted(row, reverse=True)


def test_chunked_batches_match_one_chunk(indexes, corpus):
    port, _ = indexes
    q_idx, q_w = port.encode_queries(corpus[3])
    whole = port.search_encoded(q_idx, q_w, 10, backend="taat")
    plan = port._search_plan("taat", 10)
    plan["max_b"] = 8
    chunks = list(port._chunk_queries(plan, q_idx, q_w))
    assert [c[2] for c in chunks] == [8, 8, 4]
    assert all(c[0].shape == (8, q_idx.shape[1]) for c in chunks)
    out = ([], [])
    for ci, cw, take in chunks:
        s, i = port._resolve_encoded(port._dispatch_encoded(plan, ci, cw),
                                     take)
        out[0].extend(s)
        out[1].extend(i)
    assert _sets(*out) == _sets(*whole)


def test_build_layouts_match_jax(indexes):
    port, ref = indexes
    assert port.term_to_idx == ref.term_to_idx
    for name in ("doc_terms", "doc_weights", "csr_offsets", "csr_docs",
                 "csr_weights"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name))
    assert port._int16_exact() and ref._int16_exact()


def test_from_selected_terms_and_add_match_jax():
    rng = np.random.default_rng(1)
    vocab = 60
    cmap = np.arange(vocab, dtype=np.int32)
    cmap[30:40] = np.arange(10, 20)      # colliding ids fold together
    cmap[55] = -1                        # dropped id
    rows = []
    for _ in range(25):
        t = rng.integers(0, vocab, size=15).astype(np.int32)
        w = rng.integers(-3, 200, size=15).astype(np.int32)
        rows.append((t, w))
    ids = [str(i) for i in range(25)]
    port = ImpactIndex.from_selected_terms(
        ids, [SelectedTerms(t, w) for t, w in rows], cmap, device="cpu")
    ref = JImpactIndex.from_selected_terms(
        ids, [JSelectedTerms(t, w) for t, w in rows], cmap)
    assert port.query_canonical and port.int_keyed
    assert port.term_to_idx == ref.term_to_idx
    np.testing.assert_array_equal(port.csr_docs, ref.csr_docs)
    for widths in ([6] * 7, [1, 6, 3, 15, 2, 9, 4]):   # equal, ragged
        q = [SelectedTerms(t[:k], w[:k]) for k, (t, w) in zip(widths, rows)]
        jq = [JSelectedTerms(t[:k], w[:k])
              for k, (t, w) in zip(widths, rows)]
        for a, b in zip(port.encode_query_terms(q, cmap),
                        ref.encode_query_terms(jq, cmap)):
            np.testing.assert_array_equal(a, b)
        got = port.search_terms(q, 10, canonical_map=cmap, backend="taat")
        want = ref.search_terms(jq, 10, canonical_map=cmap,
                                backend="matmul")
        assert _sets(*got) == _sets(*want)

    docs = [(i, {f"t{t}": int(w) for t, w in zip(*r)})
            for i, r in zip(ids, rows)]
    port_s, ref_s = ImpactIndex(device="cpu"), JImpactIndex()
    port_s.add_many(docs)
    ref_s.add_many(docs)
    qs = [{f"t{t}": int(w) for t, w in zip(tr[:5], wr[:5])}
          for tr, wr in rows[:5]]
    assert _sets(*port_s.search(qs, 10, backend="taat")) == \
        _sets(*ref_s.search(qs, 10, backend="matmul"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_saved_index_loads_in_the_other_package(indexes, corpus, tmp_path,
                                                writer):
    port, ref = indexes
    if writer == "port":
        port.save(str(tmp_path))
        loaded = JImpactIndex.load(str(tmp_path))
        searcher, other = loaded, port
    else:
        ref.save(str(tmp_path))
        loaded = ImpactIndex.load(str(tmp_path), device="cpu")
        searcher, other = loaded, ref
    assert loaded.term_to_idx == other.term_to_idx
    assert loaded.doc_ids == other.doc_ids
    q_idx, q_w = port.encode_queries(corpus[3])
    assert _sets(*searcher.search_encoded(q_idx, q_w, 10, backend="matmul")) \
        == _sets(*other.search_encoded(q_idx, q_w, 10, backend="matmul"))


def test_search_rejects_bad_arguments(indexes):
    port, _ = indexes
    q_idx = np.zeros((2, 64), np.int32)
    q_w = np.zeros((2, 64), np.float32)
    with pytest.raises(ValueError, match="backend"):
        port.search_encoded(q_idx, q_w, 10, backend="dense")
    q_idx[0, 0], q_w[0, 0] = N_TERMS + 1, 5.0
    with pytest.raises(ValueError, match="outside"):
        port.search_encoded(q_idx, q_w, 10)
    with pytest.raises(ValueError, match="shape"):
        port.search_encoded(q_idx, q_w[:, :3], 10)

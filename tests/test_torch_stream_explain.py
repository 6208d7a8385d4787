"""PyTorch port, ``ImpactIndex.search_encoded_stream`` /
``search_terms_stream`` and ``ImpactIndex.explain``, against the port's own
serial search and the JAX package on the same seeded inputs.

Tolerance: exact. Scores are integer impact sums, exact in f32 on both
sides; a stream must give each batch exactly what ``search_encoded`` gives
it (the same programs on the same chunks), and rows compare as (score, id)
sets, because docs of equal score may come out in any order.
``explain``'s score is host arithmetic on the same integers, equal to the
engine's.
"""

import numpy as np
import pytest

from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpactIndex
from mllm_sparse_retrieval_tpu_torch.index import ImpactIndex
from mllm_sparse_retrieval_tpu_torch.index import impact as impact_mod
from mllm_sparse_retrieval_tpu_torch.sparse import SelectedTerms

N_DOCS, N_TERMS, DOC_K = 200, 30, 6


def _sets(scores, ids):
    return [{(float(s), str(i)) for s, i in zip(sr, ir)}
            for sr, ir in zip(scores, ids)]


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(13)
    doc_t = np.argsort(rng.random((N_DOCS, N_TERMS)), axis=1)[:, :DOC_K]
    doc_w = rng.integers(1, 200, size=(N_DOCS, DOC_K)).astype(np.float32)
    doc_w[:, -1] = 0                   # padding entries
    ids = [f"d{i}" for i in range(N_DOCS)]
    port = ImpactIndex.from_packed_arrays(doc_t.astype(np.int32), doc_w, ids,
                                          range(N_TERMS), device="cpu")
    ref = JImpactIndex.from_packed_arrays(doc_t.astype(np.int32), doc_w, ids,
                                          range(N_TERMS))
    batches = []
    for b in (16, 40, 3, 16):          # the 40 spans three chunks of 16
        q_i = rng.integers(0, N_TERMS, size=(b, 5)).astype(np.int32)
        q_w = rng.integers(-3, 200, size=(b, 5)).astype(np.float32)
        batches.append((q_i, q_w))
    return port, ref, batches


def _narrow_chunks(index, max_b):
    """Set the index's device budget so a search chunks at ``max_b``
    queries."""
    index._search_plan("taat", 7)      # both device matrices resident
    plan = index._search_plan("matmul", 7)
    resident = sum(d.numel() * d.element_size()
                   for d in index._dev.values())
    per_query = plan["dev"].shape[1] * 4 * impact_mod._SCORE_MEMORY_FACTOR
    index.hbm_budget_bytes = resident + max_b * per_query


@pytest.mark.parametrize("wire", ["i32", "compact48"])
@pytest.mark.parametrize("backend", ["taat", "matmul"])
def test_stream_equals_serial_search_and_jax(pair, backend, wire):
    port, ref, batches = pair
    _narrow_chunks(port, 16)
    try:
        assert port._search_plan(backend, 7)["max_b"] == 16
        serial = [port.search_encoded(qi, qw, 7, backend=backend, wire=wire)
                  for qi, qw in batches]
        got = list(port.search_encoded_stream(iter(batches), 7,
                                              backend=backend, wire=wire,
                                              lookahead=2))
    finally:
        port.hbm_budget_bytes = port.DEFAULT_HBM_BUDGET_BYTES
    want = list(ref.search_encoded_stream(iter(batches), 7,
                                          backend="matmul", wire=wire))
    assert len(got) == len(serial) == len(want) == len(batches)
    for (qi, _), g, s, w in zip(batches, got, serial, want):
        assert len(g[0]) == qi.shape[0]
        assert g[0] == s[0] == w[0]              # rank-wise scores
        assert _sets(*g) == _sets(*s)
        for gs, gi, wi in zip(g[0], g[1], w[1]):
            cut = gs[-1] if len(gs) == 7 else -1.0
            assert {(x, d) for x, d in zip(gs, gi) if x > cut} == \
                {(x, d) for x, d in zip(gs, wi) if x > cut}


def test_stream_checks_each_batch_and_keeps_order(pair):
    port, _, batches = pair
    bad = (batches[0][0], batches[0][1] + 0.5)
    # a batch is checked when the pipeline takes it, before the result of
    # the batch ahead of it is read
    for lookahead in (1, 3):
        out = []
        with pytest.raises(ValueError, match="integer query weights"):
            for res in port.search_encoded_stream(
                    iter([batches[0], bad]), 7, backend="matmul",
                    wire="compact48", lookahead=lookahead):
                out.append(res)
        assert out == []
    # one result per batch, in order, whatever the lookahead
    for lookahead in (1, 4):
        got = list(port.search_encoded_stream(
            iter(batches), 7, backend="matmul", lookahead=lookahead))
        assert [len(s) for s, _ in got] == [qi.shape[0] for qi, _ in batches]
    assert list(port.search_encoded_stream(iter([]), 7)) == []


@pytest.mark.parametrize("wire", ["i32", "compact48"])
def test_terms_stream_equals_search_terms(wire):
    rng = np.random.default_rng(14)
    docs = [SelectedTerms(np.argsort(rng.random(50))[:8].astype(np.int32),
                          rng.integers(1, 90, size=8).astype(np.int32))
            for _ in range(120)]
    index = ImpactIndex.from_selected_terms([f"d{i}" for i in range(120)],
                                            docs, device="cpu")
    batches = [[SelectedTerms(rng.integers(0, 60, size=w).astype(np.int32),
                              rng.integers(0, 40, size=w).astype(np.int32))
                for _ in range(b)] for b, w in ((8, 6), (5, 9), (8, 6))]
    got = list(index.search_terms_stream(iter(batches), 9, backend="taat",
                                         wire=wire))
    want = [index.search_terms(b, 9, backend="taat", wire=wire)
            for b in batches]
    assert [_sets(*g) for g in got] == [_sets(*w) for w in want]
    assert [g[0] for g in got] == [w[0] for w in want]


def test_explain_matches_search_and_jax():
    """The JAX package's explain test (tests/test_explain.py): int(w)
    truncation, a negative weight and an out-of-vocabulary term dropped,
    contributions descending, the score equal to the engine's."""
    port, ref = ImpactIndex(device="cpu"), JImpactIndex()
    for index in (port, ref):
        index.add("a", {1: 5, 2: 3, 7: 11})
        index.add("b", {2: 9, 3: 1})
        index.finalize()
    q = {1: 2.9, 2: 1.0, 3: -4.0, 99: 5.0}
    for backend in ("taat", "matmul"):
        scores, ids = port.search([q], 5, backend=backend)
        engine = dict(zip(ids[0], scores[0]))
        for doc in ("a", "b"):
            ex = port.explain(q, doc)
            assert ex == ref.explain(q, doc)
            assert ex["score"] == engine[doc]
    ex = port.explain(q, "a")
    assert [(r["term"], r["contribution"]) for r in ex["terms"]] == \
        [(1, 10.0), (2, 3.0)]
    assert set(ex["dropped"]) == {3, 99}
    zero = port.explain({3: 2.0}, "a")
    assert zero == ref.explain({3: 2.0}, "a")
    assert zero["score"] == 0.0 and zero["terms"] == [] and \
        zero["dropped"] == [3]
    with pytest.raises(KeyError):
        port.explain(q, "nope")


def test_explain_scores_the_served_top_docs(pair):
    port, ref, batches = pair
    q_i, q_w = batches[0]
    queries = [{int(t): float(w) for t, w in zip(ti, wi)}
               for ti, wi in zip(q_i, q_w)]
    for wire in ("i32", "compact48"):
        scores, ids = port.search(queries, 3, backend="taat", wire=wire)
        for q, srow, irow in zip(queries, scores, ids):
            for s, d in zip(srow, irow):
                ex = port.explain(q, d)
                assert ex["score"] == s == ref.explain(q, d)["score"]
                assert ex["score"] == sum(r["contribution"]
                                          for r in ex["terms"])

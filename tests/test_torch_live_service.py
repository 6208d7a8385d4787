"""PyTorch port, the service's live surface (``serving/service.py``) against
the JAX package's service: live sparse, dense and hybrid services over the
arena and the segment classes take the same adds, replaces and deletes and
serve the same results; a rejected ``add_documents`` leaves both engines
unchanged; ``reload_indexes`` and ``load_live_state``; the refusals; and an
add from another thread after a served text search (the encoder runs under
``torch.inference_mode``, which must not reach the index tensors).

Tolerances: every result row compares as a set of ``(doc_id, round(score,
4))`` pairs at a depth that covers the whole corpus (so no tie falls at a
cut); the corpora are integer-valued, so sparse scores are exact and dense
ones exact in f32 too; fused scores agree within 1e-5 (the rounding).
"""

import threading

import numpy as np
import pytest

from mllm_sparse_retrieval_tpu.index import arena as jarena
from mllm_sparse_retrieval_tpu.index import live as jlive
from mllm_sparse_retrieval_tpu.index.dense import DenseFlatIndex as JDense
from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpact
from mllm_sparse_retrieval_tpu.serving import RetrievalService as JService
from mllm_sparse_retrieval_tpu.serving.service import (
    load_live_state as j_load_live_state)
from mllm_sparse_retrieval_tpu_torch.configs import (
    ModelConfig, ModelFamily, SparseConfig)
from mllm_sparse_retrieval_tpu_torch.index import (
    ArenaDenseIndex, ArenaImpactIndex, DenseFlatIndex, ImpactIndex,
    LiveDenseIndex, LiveImpactIndex)
from mllm_sparse_retrieval_tpu_torch.models import build_model
from mllm_sparse_retrieval_tpu_torch.serving import (
    OnlineQueryEncoder, RetrievalService, load_live_state)
from tests.test_torch_arena import THREAD_LIMIT_S, _int_reps, _sparse_docs

N_DOCS, DIM, DEPTH = 30, 12, 100
VOCAB = np.arange(50)
CLASSES = {"arena": ((jarena.ArenaDenseIndex, jarena.ArenaImpactIndex),
                     (ArenaDenseIndex, ArenaImpactIndex)),
           "segments": ((jlive.LiveDenseIndex, jlive.LiveImpactIndex),
                        (LiveDenseIndex, LiveImpactIndex))}
SVC = dict(depth_levels=(10, DEPTH), default_depth=DEPTH, backend="matmul",
           max_batch=4, max_wait_ms=2.0, alpha=0.3)


def _row_set(row):
    return {(d, round(float(s), 4)) for d, s in row}


def _corpus(seed=11):
    rng = np.random.default_rng(seed)
    ids = [f"d{i}" for i in range(N_DOCS)]
    return rng, _sparse_docs(rng, ids, VOCAB, 5), \
        dict(zip(ids, _int_reps(rng, N_DOCS, DIM)))


def _static_pair(docs, reps):
    """(JAX indexes, port indexes) over one corpus: (dense, impact)."""
    out = []
    for dense_cls, impact_cls, kw in ((JDense, JImpact, {}),
                                      (DenseFlatIndex, ImpactIndex,
                                       {"device": "cpu"})):
        impact = impact_cls(**kw)
        impact.add_many(sorted(docs.items()))
        dense = dense_cls(**kw)
        ids = sorted(reps)
        dense.add(np.stack([reps[i] for i in ids]), ids)
        out.append((dense, impact))
    return out


def _live(impl, mode, docs, reps):
    """(JAX service, port service) over live indexes of ``impl``."""
    (jd_cls, js_cls), (pd_cls, ps_cls) = CLASSES[impl]
    (jd, js), (pd, ps) = _static_pair(docs, reps)
    kw = {"doc_headroom": 8} if impl == "arena" else {}
    skw = {"doc_headroom": 8, "term_headroom": 4} if impl == "arena" else {}
    jargs = (jd_cls(jd, **kw) if mode != "sparse" else None,
             js_cls(js, **skw) if mode != "dense" else None)
    pargs = (pd_cls(pd, **kw) if mode != "sparse" else None,
             ps_cls(ps, **skw) if mode != "dense" else None)
    return JService(*jargs, **SVC), RetrievalService(*pargs, **SVC)


def _mutate(svcs, rng, mode):
    """The same adds (past the arena's headroom), a replace and deletes
    through both services."""
    new_ids = [f"n{i}" for i in range(12)] + ["d1"]
    terms = _sparse_docs(rng, new_ids, np.arange(40, 60), 4)
    reps = _int_reps(rng, len(new_ids), DIM)
    docs = []
    for i, d in enumerate(new_ids):
        doc = {"id": d}
        if mode != "dense":
            doc["terms"] = terms[d]
        if mode != "sparse":
            doc["dense"] = reps[i]
        docs.append(doc)
    for svc in svcs:
        assert svc.add_documents(docs[:5]) == 5
        assert svc.add_documents(docs[5:]) == 8
        assert svc.delete_documents(["d3", "n2", "ghost"]) == 2


def _queries(rng, mode, n=5):
    out = []
    for _ in range(n):
        q = {}
        if mode != "dense":
            q["terms"] = {int(t): float(rng.integers(1, 8))
                          for t in rng.choice(np.arange(60), 6,
                                              replace=False)}
        if mode != "sparse":
            q["dense"] = _int_reps(rng, 1, DIM)[0]
        out.append(q)
    return out


def _assert_same(jsvc, svc, queries):
    for q in queries:
        want, got = jsvc.search(**q), svc.search(**q)
        assert _row_set(got) == _row_set(want)
        assert len(got) > 0


@pytest.mark.parametrize("mode", ["sparse", "dense", "hybrid"])
@pytest.mark.parametrize("impl", ["arena", "segments"])
def test_live_service_matches_jax(impl, mode):
    rng, docs, reps = _corpus()
    jsvc, svc = _live(impl, mode, docs, reps)
    try:
        assert svc.live and svc.mode == mode
        queries = _queries(rng, mode)
        _assert_same(jsvc, svc, queries)
        _mutate((jsvc, svc), rng, mode)
        _assert_same(jsvc, svc, queries)
        stats, jstats = svc.stats(), jsvc.stats()
        for key in ("dense_docs", "sparse_docs", "dense_segments",
                    "sparse_segments", "live", "mode"):
            assert stats.get(key) == jstats.get(key), key
        assert svc.compact() == jsvc.compact()
        _assert_same(jsvc, svc, queries)
    finally:
        jsvc.close()
        svc.close()


@pytest.mark.parametrize("impl", ["arena", "segments"])
def test_rejected_add_leaves_both_engines_unchanged(impl):
    rng, docs, reps = _corpus()
    _, svc = _live(impl, "hybrid", docs, reps)
    try:
        before = (svc.impact_index.num_docs, svc.dense_index.num_docs)
        good = {"id": "ok", "terms": {1: 2.0}, "dense": [1.0] * DIM}
        for bad, match in (
                ({"terms": {1: 1}, "dense": [0.0] * DIM}, "'id'"),
                ({"id": "z", "dense": [0.0] * DIM}, "terms"),
                ({"id": "z", "terms": {1: 1}, "dense": [0.0] * (DIM + 1)},
                 "dense dim"),
                ({"id": "\x00__pad__", "terms": {1: 1},
                  "dense": [0.0] * DIM}, "pad id")):
            with pytest.raises(ValueError, match=match):
                svc.add_documents([good, bad])
            assert (svc.impact_index.num_docs,
                    svc.dense_index.num_docs) == before
            assert svc.search(terms={1: 2.0}, dense=[1.0] * DIM,
                              depth=DEPTH)[0][0] != "ok"
        assert svc.add_documents([]) == 0
    finally:
        svc.close()


def test_refusals():
    rng, docs, reps = _corpus()
    (_, _), (dense, impact) = _static_pair(docs, reps)
    live_s = ArenaImpactIndex(impact, device="cpu")
    live_d = ArenaDenseIndex(dense, device="cpu")
    (_, _), (dense2, impact2) = _static_pair(docs, reps)
    with pytest.raises(ValueError, match="live"):
        RetrievalService(dense2, live_s, **SVC)
    with pytest.raises(ValueError, match="live"):
        RetrievalService(live_d, impact2, **SVC)
    with pytest.raises(ValueError, match="live_state_dir"):
        RetrievalService(dense2, impact2, live_state_dir="x", **SVC)
    svc = RetrievalService(live_d, live_s, **SVC)
    static = RetrievalService(dense2, impact2, **SVC)
    try:
        with pytest.raises(ValueError, match="static"):
            svc.register_filter("t", ["d1"])
        with pytest.raises(ValueError, match="static serving"):
            svc.reload_indexes(dense2, impact2)
        with pytest.raises(ValueError, match="no directory"):
            svc.save_live()
        for call in (lambda: static.add_documents([{"id": "a"}]),
                     lambda: static.delete_documents(["a"]),
                     static.compact, lambda: static.save_live("x")):
            with pytest.raises(ValueError, match="live"):
                call()
        with pytest.raises(ValueError, match="static indexes"):
            static.reload_indexes(live_d, live_s)
        with pytest.raises(ValueError, match="presence"):
            static.reload_indexes(None, impact2)
    finally:
        svc.close()
        static.close()


def test_reload_indexes_swaps_engines_and_rebuilds_filters():
    """A hybrid static service (fused on the device, filtered requests on
    the host) reloads new indexes; its results and filters follow them."""
    rng, docs, reps = _corpus()
    (jd, js), (pd, ps) = _static_pair(docs, reps)
    jsvc = JService(jd, js, filters={"t": ["d1", "d2", "n1"]}, **SVC)
    svc = RetrievalService(pd, ps, filters={"t": ["d1", "d2", "n1"]}, **SVC)
    try:
        queries = _queries(rng, "hybrid")
        _assert_same(jsvc, svc, queries)
        docs2 = dict(docs)
        docs2.pop("d1")
        docs2.update(_sparse_docs(rng, ["n1", "n2"], VOCAB, 5))
        reps2 = dict(reps)
        reps2.pop("d1")
        reps2.update(zip(["n1", "n2"], _int_reps(rng, 2, DIM)))
        (jd2, js2), (pd2, ps2) = _static_pair(docs2, reps2)
        jsvc.reload_indexes(jd2, js2)
        svc.reload_indexes(pd2, ps2)
        assert svc.impact_index is ps2 and svc.dense_index is pd2
        assert svc._fused.dense is pd2 and svc._fused.impact is ps2
        _assert_same(jsvc, svc, queries)
        for q in queries:
            got = svc.search(filter="t", **q)
            assert {d for d, _ in got} <= {"d2", "n1"}
            assert _row_set(got) == _row_set(jsvc.search(filter="t", **q))
        (_, _), (bad_d, bad_s) = _static_pair(
            docs2, {k: np.ones(DIM + 1, np.float32) for k in reps2})
        with pytest.raises(ValueError, match="dim"):
            svc.reload_indexes(bad_d, bad_s)
    finally:
        jsvc.close()
        svc.close()


@pytest.mark.parametrize("impl", ["arena", "segments"])
def test_save_live_and_load_live_state_both_packages(tmp_path, impl):
    """A port save restores through the port's and the JAX package's
    ``load_live_state``; a JAX save through the port's. All serve the
    saving service's results."""
    rng, docs, reps = _corpus()
    jsvc, svc = _live(impl, "hybrid", docs, reps)
    queries = _queries(rng, "hybrid")
    try:
        _mutate((jsvc, svc), rng, "hybrid")
        want = [svc.search(**q) for q in queries]
        assert svc.save_live(str(tmp_path / "p")) == str(tmp_path / "p")
        jsvc.save_live(str(tmp_path / "j"))
    finally:
        jsvc.close()
        svc.close()
    restored = [
        RetrievalService(*load_live_state(str(tmp_path / "p"),
                                          device="cpu"), **SVC),
        RetrievalService(*load_live_state(str(tmp_path / "j"),
                                          device="cpu"), **SVC),
        JService(*j_load_live_state(str(tmp_path / "p")), **SVC)]
    try:
        for back in restored:
            assert back.live
            for q, row in zip(queries, want):
                assert _row_set(back.search(**q)) == _row_set(row)
        kinds = {type(back.dense_index).__name__ for back in restored}
        assert kinds == {"ArenaDenseIndex" if impl == "arena"
                         else "LiveDenseIndex"}
    finally:
        for back in restored:
            back.close()
    with pytest.raises(FileNotFoundError):
        load_live_state(str(tmp_path / "nothing"), device="cpu")


def test_add_from_another_thread_after_a_served_text_search():
    """The text encode runs under ``torch.inference_mode``; the impact
    matrix it is searched against must still take in-place writes from an
    HTTP handler thread afterwards."""
    caps = [f"a photo of thing{i} near place{i % 5}" for i in range(16)]
    params, arch, tok, tmpl = build_model(
        ModelConfig(family=ModelFamily.TINY_DEBUG, dtype="float32",
                    tiny_vocab_size=256, tiny_hidden_size=32,
                    tiny_num_layers=1, tiny_num_heads=2),
        captions=caps, device="cpu")
    enc = OnlineQueryEncoder(params, arch, tok, tmpl, SparseConfig(),
                             max_text_len=32, device="cpu")
    _, terms = enc.encode_texts(caps, pad_to=16)
    base = ImpactIndex(device="cpu")
    base.add_many((f"c{i}", {int(t): max(1, int(w)) for t, w in zip(
        st.token_ids, st.weights)}) for i, st in enumerate(terms))
    arena = ArenaImpactIndex(base, device="cpu")
    svc = RetrievalService(impact_index=arena, query_encoder=enc,
                           depth_levels=(10,), max_batch=4, max_wait_ms=1.0,
                           backend="taat")
    try:
        first = svc.search(text=caps[3])
        assert first and arena._inner._dev
        assert not any(t.is_inference() for t in arena._inner._dev.values())
        errors = []
        top = first[0][0]

        def add_and_delete():
            try:
                svc.add_documents([{"id": "late", "terms": dict(
                    (int(t), 500) for t in terms[3].token_ids[:4])}])
                svc.delete_documents([top])
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        t = threading.Thread(target=add_and_delete)
        t.start()
        t.join(THREAD_LIMIT_S)
        assert not t.is_alive() and errors == []
        again = svc.search(text=caps[3])
        assert again[0][0] == "late" and top not in {d for d, _ in again}
    finally:
        svc.close()

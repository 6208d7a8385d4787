"""PyTorch port, the arena live indexes (``index/arena.py``) against the JAX
package's ``ArenaImpactIndex`` / ``ArenaDenseIndex`` on the same seeded
operation sequences: adds, replaces, deletes, growth past the headroom,
compaction, the int16 drop, an empty start with string keys, save in one
package and load in the other, and a reader racing a writer.

Tolerances: results compare as ``(score, id)`` rows up to ties at the cut
(every score group but the lowest by id set, the lowest by size). Impact
scores are integers and must be equal exactly; dense scores within 1e-5
(integer-valued reps make them exact too). The device matrix after the
mutations must equal, exactly, one built from the arena's live rows with
the dead columns zero. Each test that starts threads joins them within its
own time limit.
"""

import threading

import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.index.arena import (
    ArenaDenseIndex as JArenaDense, ArenaImpactIndex as JArenaImpact)
from mllm_sparse_retrieval_tpu.index.dense import DenseFlatIndex as JDense
from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpact
from mllm_sparse_retrieval_tpu_torch.index import (
    ArenaDenseIndex, ArenaImpactIndex, DenseFlatIndex, ImpactIndex)
from mllm_sparse_retrieval_tpu_torch.index.arena import _RWLock

DENSE_TOL = 1e-5
THREAD_LIMIT_S = 60


def _groups(scores, ids):
    out = {}
    for s, i in zip(scores, ids):
        out.setdefault(float(s), set()).add(i)
    return out


def assert_rows_equal(got, want, tol=0.0):
    """Ragged rows equal up to ties at the cut: scores rank for rank
    (exactly, or within ``tol``), ids as sets within each score group, the
    lowest group (where the cut may fall) by size."""
    (gs, gi), (ws, wi) = got, want
    assert len(gs) == len(ws)
    for q, (s_a, i_a, s_b, i_b) in enumerate(zip(gs, gi, ws, wi)):
        assert len(s_a) == len(s_b), f"query {q}: {len(s_a)} != {len(s_b)}"
        if tol == 0.0:
            assert [float(s) for s in s_a] == [float(s) for s in s_b], q
        else:
            np.testing.assert_allclose(s_a, s_b, rtol=tol, atol=tol)
            s_a = [round(float(s), 4) for s in s_a]
            s_b = [round(float(s), 4) for s in s_b]
        ga, gb = _groups(s_a, i_a), _groups(s_b, i_b)
        assert set(ga) == set(gb), f"query {q} score groups"
        low = min(ga) if ga else None
        for s, ids in ga.items():
            if s == low:
                assert len(ids) == len(gb[s]), f"query {q} at {s}"
            else:
                assert ids == gb[s], f"query {q} at {s}"


def _sparse_docs(rng, ids, vocab, k, hi=30):
    return {d: {int(t): int(w) for t, w in zip(
        rng.choice(vocab, k, replace=False), rng.integers(1, hi, k))}
        for d in ids}


def _queries(rng, vocab, n, k=5):
    return [{int(t): int(w) for t, w in zip(
        rng.choice(vocab, k, replace=False), rng.integers(1, 4, k))}
        for _ in range(n)]


def _oracle_sparse(state, queries, depth):
    """A static port index rebuilt from the live documents (matmul)."""
    idx = ImpactIndex(device="cpu")
    if not state:
        return [[] for _ in queries], [[] for _ in queries]
    idx.add_many(sorted(state.items()))
    return idx.search(queries, depth, backend="matmul")


def _impact_pair(base_docs, **kw):
    jbase = pbase = None
    if base_docs is not None:
        jbase, pbase = JImpact(), ImpactIndex(device="cpu")
        jbase.add_many(base_docs.items())
        pbase.add_many(base_docs.items())
    return (JArenaImpact(jbase, **kw),
            ArenaImpactIndex(pbase, device="cpu", **kw))


def _live_matrix(arena):
    """The ``[T'+1, N_pad]`` matrix a fresh build of the arena's live rows
    gives at its columns: live docs' weights, dead columns zero."""
    inner = arena._inner
    dev = next(iter(inner._dev.values()))
    want = np.zeros(tuple(dev.shape), np.float32)
    for pos in np.nonzero(arena._live)[0]:
        for t, w in zip(inner.doc_terms[pos], inner.doc_weights[pos]):
            if w > 0:
                want[t + 1, pos] = w
    return want


@pytest.mark.parametrize("backend", ["matmul", "taat"])
def test_impact_arena_workload_matches_jax(backend):
    """Adds, a replace, deletes, growth over the doc and term headroom,
    the int16 drop and compaction, searched after every step."""
    rng = np.random.default_rng(3)
    vocab = np.arange(90)
    state = _sparse_docs(rng, [f"b{i}" for i in range(30)], vocab[:60], 6)
    jarena, arena = _impact_pair(dict(state), doc_headroom=16,
                                 term_headroom=8)
    queries = _queries(rng, vocab, 6)

    def check(depth=9):
        got = arena.search_rows(queries, depth, backend=backend)
        assert_rows_equal(got, jarena.search_rows(queries, depth,
                                                  backend="matmul"))
        assert_rows_equal(got, _oracle_sparse(state, queries, depth))
        assert arena.num_docs == jarena.num_docs == len(state)

    check()
    steps = [("x", 7, vocab[:60]), ("y", 12, vocab),   # new terms; growth
             ("z", 5, vocab)]
    for tag, n, voc in steps:
        docs = _sparse_docs(rng, [f"{tag}{i}" for i in range(n)], voc, 6)
        docs["b1"] = {int(vocab[0]): 17, int(vocab[61]): 2}     # replace
        for a in (jarena, arena):
            a.add_documents(list(docs.items()))
        state.update(docs)
        dead = ["b3", f"{tag}2", "ghost"]
        assert arena.delete_documents(dead) == jarena.delete_documents(dead)
        for d in dead:
            state.pop(d, None)
        check()
    assert arena._inner.doc_capacity > 30 + 16      # grew
    big = {"big": {int(vocab[0]): 40_000, int(vocab[1]): 3}}
    for a in (jarena, arena):
        a.add_documents(list(big.items()))
    state.update(big)
    assert arena._inner._i16_ok is False
    assert "i16" not in (arena._inner._dev or {})
    check()
    for a in (jarena, arena):
        a.compact()
    check(depth=50)


def test_impact_arena_device_matrix_equals_live_rebuild():
    """After adds, replaces and deletes, every cached matrix (the TAAT
    kernel's int16 and the matmul f32) equals the live rows exactly, with
    the dead columns zero; the int16 matrix kept its storage throughout."""
    rng = np.random.default_rng(4)
    vocab = np.arange(50)
    base = _sparse_docs(rng, [f"b{i}" for i in range(20)], vocab[:40], 5)
    _, arena = _impact_pair(base, doc_headroom=64, term_headroom=16)
    q = _queries(rng, vocab, 3)
    arena.search_rows(q, 5, backend="taat")
    arena.search_rows(q, 5, backend="matmul")
    i16 = arena._inner._dev["i16"]
    ptr = i16.data_ptr()
    for step in range(3):
        docs = _sparse_docs(rng, [f"n{step}_{i}" for i in range(6)], vocab,
                            5)
        docs[f"b{step}"] = {int(vocab[45]): 9}                # replace
        arena.add_documents(list(docs.items()))
        arena.delete_documents([f"b{10 + step}", f"n{step}_1"])
    want = _live_matrix(arena)
    for key, dev in arena._inner._dev.items():
        assert np.array_equal(dev.float().numpy(), want), key
    assert arena._inner._dev["i16"].data_ptr() == ptr


def test_impact_arena_empty_start_with_string_keys():
    jarena, arena = _impact_pair(None, doc_headroom=8, term_headroom=4,
                                 term_keys="str")
    assert not arena.int_keyed and not jarena.int_keyed
    assert arena.search_rows([{"a": 1}], 5) == ([[]], [[]])
    docs = [("d0", {"hello": 3, "world": 1}), ("d1", {"world": 4}),
            ("d2", {"sea": 2, "hello": 1})]
    for a in (jarena, arena):
        a.add_documents(docs)
    q = [{"hello": 2, "none": 9}, {"world": 1, "sea": 3}]
    got = arena.search_rows(q, 5)
    assert_rows_equal(got, jarena.search_rows(q, 5))
    assert got == ([[6.0, 2.0], [6.0, 4.0, 1.0]], [["d0", "d2"],
                                                   ["d2", "d1", "d0"]])
    more = [(f"e{i}", {f"t{i}": i + 1, "hello": 1}) for i in range(10)]
    for a in (jarena, arena):
        a.add_documents(more)        # past both headrooms
    assert_rows_equal(arena.search_rows(q, 20), jarena.search_rows(q, 20))


def test_impact_arena_race_invalidated_form_does_not_resurrect():
    """A write that drops the cached matrix between ``search_rows``'
    unlocked check and its read lock must send the search back to the
    write-side fold, materialize and re-zero path: a matrix built from the
    CSR under the read lock alone would bring the deleted doc back."""
    _, arena = _impact_pair(None, doc_headroom=8, term_headroom=4)
    arena.add_documents([("a", {1: 3}), ("dead", {1: 9}), ("c", {2: 5})])
    arena.search_rows([{1: 1}], 5, backend="matmul")
    arena.delete_documents(["dead"])
    orig = arena._form_stale
    raced = []

    def racing(backend):
        ans = orig(backend)
        if not raced:
            raced.append(True)
            arena._inner.drop_device_cache()
        return ans

    arena._form_stale = racing
    try:
        scores, ids = arena.search_rows([{1: 1}], 5, backend="matmul")
    finally:
        arena._form_stale = orig
    assert raced and ids[0] == ["a"] and scores[0] == [3.0]
    assert arena.search_rows([{1: 1}], 5, backend="matmul") == \
        ([[3.0]], [["a"]])


def _int_reps(rng, n, d):
    return rng.integers(-9, 10, size=(n, d)).astype(np.float32)


def _dense_pair(base, dtype, **kw):
    jb = pb = None
    if base is not None:
        ids, reps = base
        jb = JDense(dtype=np.float32 if dtype == "float32" else "int8")
        jb.add(reps, ids)
        pb = DenseFlatIndex(dtype=torch.float32 if dtype == "float32"
                            else "int8", device="cpu")
        pb.add(reps, ids)
    jdt = np.float32 if dtype == "float32" else "int8"
    return (JArenaDense(jb, dtype=jdt, **kw),
            ArenaDenseIndex(pb, dtype=dtype, device="cpu", **kw))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_dense_arena_workload_matches_jax(dtype):
    rng = np.random.default_rng(5)
    d = 12
    ids = [f"b{i}" for i in range(30)]
    reps = _int_reps(rng, 30, d)
    jarena, arena = _dense_pair((ids, reps), dtype, doc_headroom=8)
    q = _int_reps(rng, 5, d)

    def check(depth=10):
        got = arena.search_rows(q, depth, batch_size=8)
        assert_rows_equal(got, jarena.search_rows(q, depth, batch_size=8),
                          DENSE_TOL)
        assert arena.num_docs == jarena.num_docs

    check()
    placed = arena._inner._corpus_dev
    for step, n in enumerate((5, 2)):       # within capacity: in place
        new = _int_reps(rng, n, d)
        new_ids = [f"n{step}_{i}" for i in range(n)] + ["b1"]
        new = np.concatenate([new, _int_reps(rng, 1, d)])
        for a in (jarena, arena):
            a.add_documents(new, new_ids)
            a.delete_documents(["b4", f"n{step}_0"])
        check()
    assert arena._inner._corpus_dev is placed
    big = _int_reps(rng, 2000, d)             # past the capacity: _grow
    for a in (jarena, arena):
        a.add_documents(big, [f"g{i}" for i in range(2000)])
    check(depth=30)
    for a in (jarena, arena):
        a.compact()
    check(depth=30)


def test_dense_arena_empty_and_fully_deleted():
    jarena, arena = _dense_pair(None, "float32", doc_headroom=8)
    assert arena.search_rows(np.zeros((2, 4), np.float32), 3) == \
        ([[], []], [[], []])
    arena.add_documents(np.ones((2, 4), np.float32), ["a", "b"])
    arena.delete_documents(["a", "b"])
    assert arena.search_rows(np.ones((1, 4), np.float32), 3) == ([[]], [[]])
    arena.add_documents(-np.ones((1, 4), np.float32), ["neg"])
    # the reserved zero rows would outrank the negative score unmasked
    assert arena.search_rows(np.ones((1, 4), np.float32), 3) == \
        ([[-4.0]], [["neg"]])


@pytest.mark.parametrize("kind", ["impact", "dense"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_save_in_one_package_load_in_the_other(tmp_path, kind, writer):
    rng = np.random.default_rng(6)
    if kind == "impact":
        docs = _sparse_docs(rng, [f"a{i}" for i in range(14)],
                            np.arange(40), 5)
        jarena, arena = _impact_pair(docs, doc_headroom=16,
                                     term_headroom=8)
        more = _sparse_docs(rng, ["m0", "m1"], np.arange(40, 50), 3)
        for a in (jarena, arena):
            a.add_documents(list(more.items()))
            a.delete_documents(["a3"])
        q = _queries(rng, np.arange(50), 4)
        search = dict(depth=10)
        load = {"jax": lambda p: ArenaImpactIndex.load(p, device="cpu"),
                "torch": JArenaImpact.load}
        tol = 0.0
    else:
        reps = _int_reps(rng, 14, 6)
        jarena, arena = _dense_pair(([f"a{i}" for i in range(14)], reps),
                                    "float32", doc_headroom=8)
        for a in (jarena, arena):
            a.add_documents(_int_reps(np.random.default_rng(1), 2, 6),
                            ["m0", "m1"])
            a.delete_documents(["a3"])
        q = _int_reps(rng, 4, 6)
        search = dict(depth=10, batch_size=4)
        load = {"jax": lambda p: ArenaDenseIndex.load(p, device="cpu"),
                "torch": JArenaDense.load}
        tol = DENSE_TOL
    src = jarena if writer == "jax" else arena
    src.save(str(tmp_path / kind))
    back = load[writer](str(tmp_path / kind))
    assert back.num_docs == arena.num_docs == 15
    assert_rows_equal(back.search_rows(q, **search),
                      arena.search_rows(q, **search), tol)


def test_rwlock_writer_excludes_readers():
    lock = _RWLock()
    inside = []
    with lock.read():
        t = threading.Thread(target=lambda: lock.write().__enter__()
                             or inside.append(1))
        t.start()
        t.join(0.2)
        assert not inside            # the writer waits for the reader
    t.join(THREAD_LIMIT_S)
    assert inside and not t.is_alive()


def test_reader_thread_racing_writer_never_sees_a_deleted_doc():
    """Searches on one thread while another adds, replaces and deletes:
    a deleted id never comes back once its delete returned, every result
    holds only ids live at some point, and both threads end in time."""
    rng = np.random.default_rng(7)
    vocab = np.arange(30)
    base = _sparse_docs(rng, [f"b{i}" for i in range(40)], vocab, 4)
    _, arena = _impact_pair(base, doc_headroom=16, term_headroom=8)
    q = _queries(rng, vocab, 4, k=8)
    deleted = set()
    errors = []
    stop = threading.Event()

    def reader():
        try:
            while not stop.is_set():
                gone = set(deleted)           # deletes finished before
                _, ids = arena.search_rows(q, 50, backend="taat")
                hit = gone & {i for row in ids for i in row}
                if hit:
                    errors.append(f"deleted ids served: {sorted(hit)}")
                    return
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    def writer():
        try:
            wrng = np.random.default_rng(8)
            for step in range(40):
                docs = _sparse_docs(wrng, [f"w{step}_{i}" for i in range(3)],
                                    vocab, 4)
                arena.add_documents(list(docs.items()))
                victim = f"b{step}"
                arena.delete_documents([victim])
                deleted.add(victim)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=reader, daemon=True),
               threading.Thread(target=writer, daemon=True)]
    for t in threads:
        t.start()
    threads[1].join(THREAD_LIMIT_S)
    stop.set()
    threads[0].join(THREAD_LIMIT_S)
    assert not any(t.is_alive() for t in threads), "threads hung"
    assert errors == []
    state = dict(base)
    for b in deleted:
        state.pop(b)
    assert arena.num_docs == len(state) + 3 * 40

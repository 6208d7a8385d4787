"""PyTorch port: the native (C++) impact builder (``index/native``) and
``ImpactIndex.from_jsonl``, against the port's Python builder and the JAX
package's ``from_jsonl`` on seeded corpus jsonl files this file writes
(unicode terms, numeric ids, JSON escapes, several shards).

Tolerance: exact. Term maps, doc ids and every layout array (packed and
CSR) must be equal, and so must search results, which are integer sums.
A compiler that cannot build the library makes ``from_jsonl(use_native=
True)`` raise: there is no silent fallback to the Python builder.
"""

import json

import numpy as np
import pytest

from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpactIndex
from mllm_sparse_retrieval_tpu_torch.index import ImpactIndex, native

LAYOUT = ("doc_terms", "doc_weights", "csr_offsets", "csr_docs",
          "csr_weights")


def _write_jsonl(path, docs):
    with open(path, "w") as f:
        for doc_id, vec in docs:
            f.write(json.dumps({"id": doc_id, "content": "",
                                "vector": vec}) + "\n")


def _corpus(seed, n_docs, start=0):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(80)] + ["café", "naïve", "éclair",
                                             "a\"b", "back\\slash", "日本"]
    # Zipf-ish term draws, so document frequencies differ and the
    # hot-first relabelling moves terms
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    docs = []
    for i in range(start, start + n_docs):
        k = int(rng.integers(1, 12))
        terms = rng.choice(vocab, size=k, replace=False, p=p)
        weights = rng.integers(1, 300, size=k)
        weights[rng.random(k) < 0.1] = 0           # dropped by both builders
        docs.append((f"doc{i}", dict(zip(terms.tolist(),
                                         [int(w) for w in weights]))))
    return docs


def _assert_same_layout(a, b):
    assert a.doc_ids == b.doc_ids
    assert a.term_to_idx == b.term_to_idx
    for name in LAYOUT:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _same_up_to_ties(got, want, depth):
    """Equal ``(doc, score)`` sets; docs tied at the depth cut may
    differ (tie order is not part of the contract)."""
    g, w = set(got), set(want)
    assert sorted(s for _, s in g) == sorted(s for _, s in w)
    cut = min(s for _, s in g) if len(got) == depth else -1.0
    assert {x for x in g if x[1] > cut} == {x for x in w if x[1] > cut}


@pytest.fixture
def shards(tmp_path):
    paths = []
    for s, (seed, n) in enumerate(((0, 90), (1, 40), (2, 1))):
        path = tmp_path / f"corpus_{s}.jsonl"
        _write_jsonl(path, _corpus(seed, n, start=1000 * s))
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("n_shards", [1, 3])
def test_native_equals_python_builder(shards, n_shards):
    paths = shards[:n_shards]
    nat = ImpactIndex.from_jsonl(paths, device="cpu")
    py = ImpactIndex.from_jsonl(paths, use_native=False, device="cpu")
    _assert_same_layout(nat, py)
    df = np.diff(nat.csr_offsets)
    assert np.all(df[:-1] >= df[1:])        # hot-first term ids


@pytest.mark.parametrize("use_native", [True, False])
def test_from_jsonl_equals_jax(shards, use_native):
    mine = ImpactIndex.from_jsonl(shards, use_native=use_native,
                                  device="cpu")
    theirs = JImpactIndex.from_jsonl(shards, use_native=False)
    _assert_same_layout(mine, theirs)


@pytest.mark.parametrize("backend", ["matmul", "taat"])
def test_native_index_searches_like_python_and_jax(shards, backend):
    nat = ImpactIndex.from_jsonl(shards, device="cpu")
    py = ImpactIndex.from_jsonl(shards, use_native=False, device="cpu")
    jx = JImpactIndex.from_jsonl(shards, use_native=False)
    rng = np.random.default_rng(5)
    keys = list(nat.term_to_idx)
    queries = [{str(t): int(w) for t, w in zip(
        rng.choice(keys, size=4, replace=False), rng.integers(1, 50, 4))}
        for _ in range(12)]
    got = nat.search(queries, 20, backend=backend)
    for other in (py.search(queries, 20, backend=backend),
                  jx.search(queries, 20, backend="matmul")):
        for s_a, i_a, s_b, i_b in zip(*got, *other):
            _same_up_to_ties(list(zip(i_a, s_a)), list(zip(i_b, s_b)), 20)


def test_numeric_ids_and_escapes(tmp_path):
    path = tmp_path / "c.jsonl"
    path.write_text(
        '{"id": 42, "content": "", "vector": {"a\\"b": 3, "\\u00e9": 2}}\n'
        '\n'
        '{"id": "x7", "content": "ignored", "vector": {"plain": 1}}\n'
        '{"content": {"nested": [1, "}"]}, "id": "y", "vector": '
        '{"\\ud83d\\ude00": 5, "plain": 0}}\n')
    for use_native in (True, False):
        idx = ImpactIndex.from_jsonl([str(path)], use_native=use_native,
                                     device="cpu")
        assert idx.doc_ids == ["42", "x7", "y"]
        assert set(idx.term_to_idx) == {'a"b', "é", "plain", "😀"}
        scores, ids = idx.search([{'a"b': 2}], depth=5)
        assert ids[0] == ["42"] and scores[0] == [6.0]
    _assert_same_layout(
        ImpactIndex.from_jsonl([str(path)], device="cpu"),
        JImpactIndex.from_jsonl([str(path)], use_native=False))


def test_native_rejects_malformed_jsonl(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text('{"id": "ok", "vector": {"a": 1}}\nnot json\n')
    with pytest.raises(ValueError, match="malformed"):
        ImpactIndex.from_jsonl([str(path)], device="cpu")
    builder = native.NativeImpactBuilder()
    with pytest.raises(ValueError, match="malformed"):
        builder.add_jsonl_bytes(b'{"vector": {"a": 1}}\n')   # no id


@pytest.mark.parametrize("cxx", ["/nonexistent/bin/g++", "false"])
def test_unusable_compiler_raises_and_never_falls_back(shards, monkeypatch,
                                                       cxx):
    good = native.library_path()
    monkeypatch.setenv("CXX", cxx)
    assert native.compiler() == cxx
    assert native.library_path() != good     # a new compiler, a new name
    with pytest.raises(RuntimeError, match="native impact builder"):
        ImpactIndex.from_jsonl(shards, device="cpu")
    with pytest.raises(RuntimeError):
        native.NativeImpactBuilder()
    assert not native.library_path().exists()
    # the Python builder is only reached when asked for
    assert ImpactIndex.from_jsonl(shards, use_native=False,
                                  device="cpu").num_docs == 131


def test_library_is_named_by_source_compiler_flags_and_host(monkeypatch):
    so = native.build()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert native.build() == so                # built once, reused
    assert native.load() is native.load()
    assert "-march=native" not in native.CXX_FLAGS
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != so
    monkeypatch.undo()
    monkeypatch.setattr(native.platform, "node", lambda: "another-host")
    assert native.library_path() != so


def test_native_index_saves_and_loads_in_both_packages(shards, tmp_path):
    nat = ImpactIndex.from_jsonl(shards, device="cpu")
    nat.save(str(tmp_path / "idx"))
    back = ImpactIndex.load(str(tmp_path / "idx"), device="cpu")
    _assert_same_layout(back, nat)
    _assert_same_layout(JImpactIndex.load(str(tmp_path / "idx")), nat)

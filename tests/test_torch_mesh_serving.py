"""PyTorch port: serving and the CLIs over a data-axis mesh
(``RetrievalService(mesh=)``, ``cli.serve --mesh``, ``cli.encode`` /
``cli.search`` / ``cli.stats --mesh``), against the JAX package's service
on 2- and 4-device CPU meshes (the conftest's virtual devices; the port's
mesh is ``make_mesh(D, devices=["cpu"] * D)``) and against the port's own
unsharded runs.

Tolerances: served rows compare as in the JAX package's
``test_service_mesh_parity``: ids as sets, sorted scores within
``rtol=1e-5, atol=1e-4`` (the integer impact scores are exact; dense and
fused scores move by f32 rounding). The CLIs' artifacts and printed
summaries under ``--mesh`` equal their runs without it (the sparse jsonl
and the summaries exactly, dense vectors within ``1e-5``). ``cli.serve
--mesh --device cpu`` serves over a 1x1 mesh (the CLI takes no repeated
devices) and answers as the JAX package's boot test expects.
"""

import pickle

import jax
import numpy as np
import pytest

from mllm_sparse_retrieval_tpu.index.dense import (
    DenseFlatIndex as JDenseFlatIndex)
from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpactIndex
from mllm_sparse_retrieval_tpu.parallel.mesh import make_mesh as j_make_mesh
from mllm_sparse_retrieval_tpu.serving import RetrievalService as JService
from mllm_sparse_retrieval_tpu_torch.cli import encode as cli_encode
from mllm_sparse_retrieval_tpu_torch.cli import search as cli_search
from mllm_sparse_retrieval_tpu_torch.cli import serve as cli_serve
from mllm_sparse_retrieval_tpu_torch.cli import stats as cli_stats
from mllm_sparse_retrieval_tpu_torch.cli import train as cli_train
from mllm_sparse_retrieval_tpu_torch.index import (
    ArenaDenseIndex, ArenaImpactIndex, DenseFlatIndex, ImpactIndex,
    LiveDenseIndex, LiveImpactIndex)
from mllm_sparse_retrieval_tpu_torch.parallel import make_mesh
from mllm_sparse_retrieval_tpu_torch.serving import RetrievalService
from test_torch_cli import (  # noqa: F401 — fixtures
    _common, _leaf, data_root, jax_model, jax_weights)
from test_torch_cli_train import _args as train_args
from test_torch_http import _Server, _request
from tests.torch_threads import one_torch_thread  # noqa: F401

N_DOCS, DIM, N_TERMS = 64, 8, 40


@pytest.fixture(scope="module")
def indexes():
    """The JAX package's ``test_serving.indexes`` corpus, in both
    packages."""
    rng = np.random.default_rng(7)
    doc_ids = [f"d{i}" for i in range(N_DOCS)]
    impact, jimpact = ImpactIndex(device="cpu"), JImpactIndex()
    for d in doc_ids:
        terms = rng.choice(N_TERMS, size=int(rng.integers(3, 9)),
                           replace=False)
        vec = {f"t{t}": int(rng.integers(1, 30)) for t in terms}
        impact.add(d, vec)
        jimpact.add(d, vec)
    impact.finalize()
    jimpact.finalize()
    order = rng.permutation(N_DOCS)
    reps = rng.normal(size=(N_DOCS, DIM)).astype(np.float32)
    dense, jdense = DenseFlatIndex(device="cpu"), JDenseFlatIndex()
    for idx in (dense, jdense):
        idx.add(reps[order], [doc_ids[i] for i in order])
    return (impact, dense), (jimpact, jdense)


def _queries(n=6, seed=3):
    rng = np.random.default_rng(seed)
    terms, denses = [], []
    for _ in range(n):
        picked = rng.choice(N_TERMS, size=4, replace=False)
        terms.append({f"t{t}": float(rng.integers(1, 9)) for t in picked})
        denses.append(rng.normal(size=DIM).astype(np.float32))
    return terms, denses


def _same_rows(got, ref):
    assert {i for i, _ in got} == {i for i, _ in ref}
    np.testing.assert_allclose(sorted(float(s) for _, s in got),
                               sorted(float(s) for _, s in ref),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("mode", ["sparse", "dense", "hybrid"])
def test_service_mesh_parity(indexes, d, mode):
    """``test_serving.test_service_mesh_parity`` of the JAX package: rows
    served over a mesh equal the JAX mesh service's and the port's
    unsharded service's, in every mode, filtered requests too; the port's
    sparse engine takes its TAAT route per shard."""
    (impact, dense), (jimpact, jdense) = indexes
    kw = {"sparse": dict(impact_index=impact), "dense": dict(
        dense_index=dense), "hybrid": dict(dense_index=dense,
                                           impact_index=impact)}[mode]
    jkw = {"sparse": dict(impact_index=jimpact), "dense": dict(
        dense_index=jdense), "hybrid": dict(dense_index=jdense,
                                            impact_index=jimpact)}[mode]
    allow = {"evens": [f"d{i}" for i in range(0, N_DOCS, 2)]}
    common = dict(depth_levels=(10,), max_batch=8, max_wait_ms=10.0,
                  filters=allow)
    services = [
        RetrievalService(backend="taat", mesh=make_mesh(
            d, devices=["cpu"] * d), **common, **kw),
        RetrievalService(backend="taat", **common, **kw),
        JService(backend="matmul", mesh=j_make_mesh(
            d, devices=jax.devices()[:d]), **common, **jkw)]
    terms, denses = _queries()
    try:
        assert services[0].mode == mode
        for t, dv in zip(terms, denses):
            q = {}
            if mode != "dense":
                q["terms"] = t
            if mode != "sparse":
                q["dense"] = dv
            for flt in (None, "evens"):
                got, single, jax_row = (
                    s.search(depth=10, filter=flt, **q) for s in services)
                assert got
                _same_rows(got, single)
                _same_rows(got, jax_row)
                if flt:
                    assert {i for i, _ in got} <= set(allow["evens"])
    finally:
        for s in services:
            s.close()


def _corpus_pair(seed):
    """Two fresh (impact, dense) pairs of one seeded corpus: live indexes
    adopt and mutate the index they wrap."""
    rng = np.random.default_rng(seed)
    docs = [(f"d{i}", {f"t{t}": int(rng.integers(1, 30)) for t in
                       rng.choice(N_TERMS, size=int(rng.integers(3, 9)),
                                  replace=False)}) for i in range(N_DOCS)]
    reps = rng.normal(size=(N_DOCS, DIM)).astype(np.float32)
    out = []
    for _ in range(2):
        impact = ImpactIndex(device="cpu")
        impact.add_many(docs)
        impact.finalize()
        dense = DenseFlatIndex(device="cpu")
        dense.add(reps, [d for d, _ in docs])
        out.append((impact, dense))
    return rng, out


@pytest.mark.parametrize("impl", ["arena", "segments"])
def test_live_service_over_a_mesh_equals_unsharded(impl):
    """A live hybrid service over a 2-shard mesh against the same service
    unsharded, through adds (new terms, a replaced id) and deletes: the
    arena writes each triple and row into its owning shard in place (the
    segment classes shard their base)."""
    rng, pairs = _corpus_pair(9)
    live = {"arena": (ArenaDenseIndex, ArenaImpactIndex),
            "segments": (LiveDenseIndex, LiveImpactIndex)}[impl]
    services = [
        RetrievalService(live[0](d, device="cpu"), live[1](i, device="cpu"),
                         backend="taat", depth_levels=(10,), max_batch=8,
                         max_wait_ms=10.0, mesh=mesh)
        for (i, d), mesh in zip(pairs, (make_mesh(2, devices=["cpu"] * 2),
                                        None))]
    terms, denses = _queries()
    new_docs = [{"id": f"n{j}", "dense": rng.normal(size=DIM).tolist(),
                 "terms": {f"t{t}": 40 for t in (j, N_TERMS + j)}}
                for j in range(5)] + [
        {"id": "d3", "dense": denses[0].tolist(), "terms": terms[0]}]
    try:
        for step in range(3):
            for t, dv in zip(terms, denses):
                rows = [s.search(terms=t, dense=dv, depth=10)
                        for s in services]
                assert rows[0]
                _same_rows(*rows)
            for s in services:
                if step == 0:
                    s.add_documents(new_docs)
                elif step == 1:
                    s.delete_documents(["d5", "n1", "d3"])
    finally:
        for s in services:
            s.close()


def test_cli_serve_mesh_boot(tmp_path):
    """``cli.serve --mesh`` boots over static artifacts, warms, and serves
    a hybrid query (the JAX package's ``test_cli_serve_mesh_boot``)."""
    impact = ImpactIndex(device="cpu")
    impact.add("a", {"w1": 5, "w2": 2})
    impact.add("b", {"w2": 9})
    impact.finalize()
    impact.save(str(tmp_path / "sparse"))
    (tmp_path / "dense").mkdir()
    with open(tmp_path / "dense" / "corpus_0.pkl", "wb") as f:
        pickle.dump((np.eye(4, dtype=np.float32)[:2], ["a", "b"]), f)
    server = _Server(["--sparse-index", str(tmp_path / "sparse"),
                      "--passage-reps", str(tmp_path / "dense"), "--mesh",
                      "--depths", "10", "--impact-backend", "matmul",
                      "--max-wait-ms", "2"], tmp_path)
    try:
        assert any("serving over a 1-device mesh" in line
                   for line in server.log)
        status, out = _request(server.base, "POST", "/search", {"queries": [
            {"terms": {"w2": 2.0}, "dense": [0.0, 1.0, 0.0, 0.0],
             "depth": 10}]})
        assert status == 200
        assert [d for d, _ in out["results"][0]] == ["b", "a"]
    finally:
        assert server.stop() == 0


def test_cli_serve_mesh_refuses_compact48(capsys):
    with pytest.raises(SystemExit) as e:
        cli_serve.parse_args(["--sparse-index", "x", "--mesh",
                              "--impact-wire", "compact48"])
    assert e.value.code == 2
    assert "compact48 is single-chip only" in capsys.readouterr().err


def test_encode_search_stats_clis_over_a_mesh(data_root, jax_weights,
                                              tmp_path, capsys, monkeypatch):
    """Each CLI under ``--mesh`` (a 1x1 mesh of the CPU here) gives its run
    without it; ``--model-parallel 2`` on one device is make_mesh's
    error; ``cli.train --mesh`` trains over a mesh
    (``test_torch_mesh_train.py``), across the processes of a launch too
    (``test_torch_multiprocess_train.py``), and under a launch without the
    launcher's address it raises ``ValueError`` naming the variable."""
    outs = {}
    for tag, flag in (("one", []), ("mesh", ["--mesh"])):
        out = tmp_path / tag
        cli_encode.main(_common(data_root) + flag + [
            "--encode-type", "image", "--dense-output-dir",
            str(out / "dense"), "--sparse-output-dir", str(out / "sparse")])
        capsys.readouterr()
        dense_dir = _leaf(out / "dense", "image")
        impact = ImpactIndex.from_jsonl(
            [str(_leaf(out / "sparse", "image") / "corpus_0.jsonl")],
            use_native=False, device="cpu")
        impact.save(str(out / "idx"))
        cli_search.main(_common(data_root) + flag + [
            "--passage-reps", str(dense_dir), "--sparse-index",
            str(out / "idx"), "--depth", "20", "--metrics", "mrr"])
        search = capsys.readouterr().out
        cli_stats.main(_common(data_root) + flag + [
            "--num-images", "4", "--out-dir", str(out / "stats")])
        stats = capsys.readouterr().out.splitlines()[0]
        with open(dense_dir / "corpus_0.pkl", "rb") as f:
            reps, ids = pickle.load(f)
        jsonl = (_leaf(out / "sparse", "image") / "corpus_0.jsonl"
                 ).read_text()
        outs[tag] = (reps, ids, jsonl, search, stats)
    (r1, i1, j1, s1, t1), (r2, i2, j2, s2, t2) = outs["one"], outs["mesh"]
    assert i1 == i2 and j1 == j2 and s1 == s2 and t1 == t2
    assert "fusion recall: r@1 " in s1
    np.testing.assert_allclose(r1, r2, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="model_parallel=2"):
        cli_encode.main(_common(data_root) + [
            "--mesh", "--model-parallel", "2", "--encode-type", "image",
            "--dense-output-dir", str(tmp_path / "x"),
            "--sparse-output-dir", str(tmp_path / "y")])
    args = cli_train.build_parser().parse_args(
        train_args(data_root, "tiny_debug", tmp_path, "--device", "cpu",
                   "--mesh"))
    monkeypatch.setenv("WORLD_SIZE", "2")
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        cli_train.run(args)

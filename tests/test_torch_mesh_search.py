"""PyTorch port: search and encode over a data-axis mesh
(``parallel/mesh.py``; the sharded impact, MIPS and ANN programs; the mesh
forms of ``fused_topk_parts`` / ``ranks_from_parts``; ``encode_examples``
with ``layers._sharded_flash``; ``run_search(mesh=)``) against the JAX
package on the same numpy-seeded inputs. The JAX side runs on 2- and
4-device CPU meshes from the conftest's 8 virtual devices, the port's on
``make_mesh(D, devices=["cpu"] * D)``.

Tolerances:

- ``make_mesh`` errors: equal messages.
- per-shard matrix blocks (fresh, and after mesh adds and deletes): exact.
- impact search: scores are integers, so every returned (score, id) pair
  is exact; with a depth past the corpus the rows are equal as sets, and
  at a small depth the scores are equal rank by rank and the docs above
  the cut score equal as sets (the cut may hold other docs of its score:
  ``torch.topk`` and ``lax.top_k`` break ties differently).
- dense MIPS (f32, SQ8) and ANN: scores within ``1e-5`` rank by rank and
  the docs above the cut (by ``2e-5``) equal; SQ8 scores are bit-equal.
- ``fused_topk_parts`` and ``ranks_from_parts`` on the same inputs: fused
  scores within ``1e-5`` up to ties at the cut, ranks exact.
- ``encode_examples(mesh=)``: the ids, dense vectors within ``1e-5`` and
  the positive (token, weight) sets of the image terms equal the JAX
  package's; the per-shard flash calls number ``data * model * layers`` a
  batch.
- ``run_search(mesh=)``: the recall summary equals the unsharded run's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.configs import SparseConfig as JSparseConfig
from mllm_sparse_retrieval_tpu.index.ann import DenseANNIndex as JANN
from mllm_sparse_retrieval_tpu.index.dense import (
    DenseFlatIndex as JDenseFlatIndex)
from mllm_sparse_retrieval_tpu.index.filter import DocFilter as JDocFilter
from mllm_sparse_retrieval_tpu.index.impact import ImpactIndex as JImpactIndex
from mllm_sparse_retrieval_tpu.ops import eval_ranks as jer
from mllm_sparse_retrieval_tpu.ops import hybrid_fusion as jhf
from mllm_sparse_retrieval_tpu.ops import mips as jmips
from mllm_sparse_retrieval_tpu.ops.packing import pack_topk as j_pack
from mllm_sparse_retrieval_tpu.ops.packing import unpack_topk as j_unpack
from mllm_sparse_retrieval_tpu.parallel.mesh import make_mesh as j_make_mesh
from mllm_sparse_retrieval_tpu.pipelines import encode as jencode
from mllm_sparse_retrieval_tpu_torch.configs import SearchConfig, SparseConfig
from mllm_sparse_retrieval_tpu_torch.index import (
    DenseANNIndex, DenseFlatIndex, DocFilter, ImpactIndex)
from mllm_sparse_retrieval_tpu_torch.models import layers as L
from mllm_sparse_retrieval_tpu_torch.ops import eval_ranks as er
from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA
from mllm_sparse_retrieval_tpu_torch.ops import hybrid_fusion as hf
from mllm_sparse_retrieval_tpu_torch.ops import mips
from mllm_sparse_retrieval_tpu_torch.ops.packing import pack_topk, unpack_topk
from mllm_sparse_retrieval_tpu_torch.parallel import (
    DATA_AXIS, MODEL_AXIS, make_mesh, replicated, shard_batch)
from mllm_sparse_retrieval_tpu_torch.pipelines import encode as pencode
from mllm_sparse_retrieval_tpu_torch.search import engine
from test_torch_offline_encode import BATCH, raw_loader, setup  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

N_DOCS, N_TERMS, N_Q, DIM = 300, 60, 9, 24
SHARDS = (2, 4)
TOL = 1e-5


def _meshes(d, model=1):
    return (j_make_mesh(d, model, devices=jax.devices()[:d * model]),
            make_mesh(d, model, devices=["cpu"] * (d * model)))


# ---- parallel/mesh.py --------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(model_parallel=0), dict(model_parallel=3),
    dict(data_parallel=3, model_parallel=2),
    dict(data_parallel=2, model_parallel=4), dict(), dict(model_parallel=2),
])
def test_make_mesh_matches_jax(kw):
    outs = []
    for build, devices in ((j_make_mesh, jax.devices()[:8]),
                           (make_mesh, ["cpu"] * 8)):
        try:
            outs.append(dict(build(devices=devices, **kw).shape))
        except ValueError as e:
            outs.append(str(e))
    assert outs[0] == outs[1]


def test_shard_batch_and_replicated_place_per_shard():
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    assert dict(mesh.shape) == {DATA_AXIS: 2, MODEL_AXIS: 2}
    assert mesh.row(1).shape[DATA_AXIS] == 1 and mesh.row(1) is mesh.row(1)
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    pieces = shard_batch(mesh, x)
    assert [p.tolist() for p in pieces] == [x[:3].tolist(), x[3:].tolist()]
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(mesh, x[:5])
    tree = {"w": torch.ones(3), "b": [torch.zeros(2), None]}
    copies = replicated(mesh, tree)
    # one device, one copy: repeated shards share it
    assert len(copies) == 2 and copies[0] is copies[1]
    assert copies[0]["w"] is tree["w"] and copies[0]["b"][1] is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


# ---- the impact index --------------------------------------------------------

def _impact_pair(seed, capacity=False):
    rng = np.random.default_rng(seed)
    mine, theirs = ImpactIndex(device="cpu"), JImpactIndex()
    for i in range(N_DOCS):
        terms = rng.choice(N_TERMS, size=int(rng.integers(3, 12)),
                           replace=False)
        vec = {f"t{t}": int(rng.integers(1, 40)) for t in terms}
        mine.add(f"d{i}", vec)
        theirs.add(f"d{i}", vec)
    for idx in (mine, theirs):
        idx.finalize()
        if capacity:
            idx.doc_capacity, idx.term_capacity = N_DOCS + 40, N_TERMS + 8
    queries = [{f"t{t}": int(rng.integers(1, 6))
                for t in rng.choice(N_TERMS, size=int(rng.integers(1, 7)),
                                    replace=False)} for _ in range(N_Q)]
    return mine, theirs, queries


def _blocks(jdev, d):
    """The JAX package's mesh form as D host blocks [T+1, shard_cols]."""
    a = np.asarray(jdev)
    if a.ndim == 4:                          # [D, T+1, s, shard/s]
        return list(a.reshape(a.shape[0], a.shape[1], -1))
    return np.split(a, d, axis=1)


def _assert_blocks_equal(mine, theirs, d, dtype):
    jm, pm = _meshes(d)
    kernel = dtype == "i16"
    got = mine._materialize(dtype, pm)
    want = _blocks(theirs._materialize(jm, dtype, kernel_layout=kernel), d)
    assert len(got) == d == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert mine._n_valid == theirs._n_valid
    return jm, pm


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("capacity", [False, True])
def test_materialize_blocks_match_jax(d, capacity):
    mine, theirs, _ = _impact_pair(0, capacity)
    for dtype in ("f32", "i16"):
        _assert_blocks_equal(mine, theirs, d, dtype)
    assert mine._mesh is not None
    mine._materialize("f32")                 # another mesh: a fresh cache
    assert mine._mesh is None and list(mine._dev) == ["f32"]


@pytest.mark.parametrize("d", SHARDS)
def test_mesh_adds_and_deletes_match_jax(d):
    mine, theirs, _ = _impact_pair(1, capacity=True)
    rng = np.random.default_rng(d)
    jm, pm = _meshes(d)
    for dtype in ("f32", "i16"):
        mine._materialize(dtype, pm)
        theirs._materialize(jm, dtype, kernel_layout=dtype == "i16")
    # adds: new docs in reserved columns (some with new term rows); one
    # delete: zeros over an existing doc's cells
    cols = np.repeat(np.arange(N_DOCS, N_DOCS + 30), 3)
    terms = np.concatenate([rng.choice(N_TERMS + 8, 3, replace=False)
                            for _ in range(30)])
    weights = rng.integers(1, 50, size=cols.size).astype(np.float32)
    dead = np.nonzero(theirs.csr_docs == 7)[0]
    dead_terms = np.searchsorted(theirs.csr_offsets, dead, side="right") - 1
    cols = np.concatenate([cols, np.full(dead.size, 7)])
    terms = np.concatenate([terms, dead_terms])
    weights = np.concatenate([weights, np.zeros(dead.size, np.float32)])
    for idx in (mine, theirs):
        idx.scatter_append_triples(terms, cols, weights)
    for dtype in ("f32", "i16"):
        got = mine._dev[dtype]
        jkey = dtype + ("/kernel" if dtype == "i16" else "")
        for g, w in zip(got, _blocks(theirs._dev[jkey], d)):
            np.testing.assert_array_equal(g.numpy(), w)
        assert not got[0][:, 7].any()


def _assert_rows_match(got, want, exact_sets):
    for gs, gi, ws, wi in zip(*got, *want):
        assert gs == ws                      # integer scores, rank by rank
        if exact_sets:
            assert set(zip(gi, gs)) == set(zip(wi, ws))
        else:
            cut = gs[-1] if gs else 0
            assert {i for i, s in zip(gi, gs) if s > cut} == \
                {i for i, s in zip(wi, ws) if s > cut}


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("backend", ["matmul", "taat"])
def test_sharded_impact_search_matches_jax(d, backend):
    mine, theirs, queries = _impact_pair(2)
    jm, pm = _meshes(d)
    allow = [f"d{i}" for i in range(0, N_DOCS, 3)]
    flt, jflt = DocFilter.from_ids(mine.doc_ids, allow), \
        JDocFilter.from_ids(theirs.doc_ids, allow)
    # the JAX TAAT runs interpreted here: one depth keeps its compiles few
    depths = (N_DOCS + 5, 7) if backend == "matmul" else (N_DOCS + 5,)
    for depth in depths:
        for f, jf in ((None, None), (flt, jflt)):
            got = mine.search(queries, depth, mesh=pm, backend=backend,
                              doc_filter=f)
            want = theirs.search(queries, depth, mesh=jm, backend=backend,
                                 doc_filter=jf)
            _assert_rows_match(got, want, depth > N_DOCS)
            # and the port's unsharded search
            _assert_rows_match(got, mine.search(queries, depth,
                                                backend=backend,
                                                doc_filter=f),
                               depth > N_DOCS)


def test_sharded_impact_programs_match_jax():
    """The programs themselves on the same blocks and queries: packed
    ``[B, 2k]`` results whose (score, id) rows agree with JAX's."""
    from mllm_sparse_retrieval_tpu.ops import score_programs as jsp

    from mllm_sparse_retrieval_tpu_torch.ops import score_programs as sp
    mine, theirs, queries = _impact_pair(3)
    jm, pm = _meshes(2)
    q_idx, q_w = theirs.encode_queries(queries)
    jdev = theirs._materialize(jm, "f32")
    blocks = mine._materialize("f32", pm)
    n_valid, k = theirs._n_valid, N_DOCS
    mask = np.zeros(blocks[0].shape[1] * 2, bool)
    mask[:N_DOCS:2] = True
    for fn, jfn, m, jmask in (
            (sp._sharded_impact_topk, jsp._sharded_impact_topk, None, None),
            (sp._sharded_taat_topk, None, None, None),
            (sp._sharded_impact_topk, jsp._sharded_impact_topk_filtered,
             shard_batch(pm, mask), JDocFilter(mask[:N_DOCS]).device_mask(
                 mask.size, jm))):
        got = unpack_topk(fn(pm, blocks, replicated(pm, q_idx),
                             replicated(pm, q_w), n_valid, k, m).numpy())
        if jfn is None:                      # TAAT: the matmul's answer
            jfn = jsp._sharded_impact_topk
        args = (jm, jdev, jnp.asarray(q_idx), jnp.asarray(q_w)) + \
            (() if jmask is None else (jmask,)) + (n_valid, k)
        want = j_unpack(np.asarray(jfn(*args)))
        for gs, gi, ws, wi in zip(*got, *want):
            keep = gs > 0
            assert set(zip(gi[keep], gs[keep])) == \
                set(zip(wi[ws > 0], ws[ws > 0]))


def test_sharded_search_refuses_compact48_as_jax():
    mine, theirs, queries = _impact_pair(4)
    jm, pm = _meshes(2)
    for idx, mesh in ((mine, pm), (theirs, jm)):
        with pytest.raises(ValueError, match="single-chip only"):
            idx.search(queries, 5, mesh=mesh, wire="compact48")


# ---- dense MIPS, SQ8 and ANN -------------------------------------------------

def _gauss(rng, n, d=DIM):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _same_up_to_ties(got, want, tol=TOL):
    (gs, gi), (ws, wi) = got, want
    gs, ws = np.asarray(gs, np.float64), np.asarray(ws, np.float64)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=tol)
    for srow, grow, wrow in zip(gs, gi, wi):
        cut = srow[-1] + 2 * tol
        assert {int(x) for x, s in zip(grow, srow) if s > cut} <= \
            {int(x) for x in wrow}


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("filtered", [False, True])
def test_sharded_mips_programs_match_jax(d, q8, filtered):
    rng = np.random.default_rng(5)
    n = 64 * d                               # rows split evenly
    corpus = _gauss(rng, n) * 3.0
    q = _gauss(rng, N_Q)
    mask = rng.random(n) < 0.4
    jm, pm = _meshes(d)
    k, n_valid = 12, n - 5
    pmask = shard_batch(pm, mask) if filtered else None
    if q8:
        c8, scale = DenseFlatIndex._quantize_rows(corpus)
        q8_, qs = DenseFlatIndex._quantize_rows(q)
        got = mips.sharded_mips_topk_q8(
            pm, torch.from_numpy(q8_), torch.from_numpy(qs),
            shard_batch(pm, c8), shard_batch(pm, scale), n_valid, k, pmask)
        jargs = (jm, jnp.asarray(q8_), jnp.asarray(qs),
                 jax.device_put(c8), jax.device_put(scale))
        want = (jmips.sharded_mips_topk_q8_filtered(
            *jargs, jnp.asarray(mask), n_valid, k) if filtered else
            jmips.sharded_mips_topk_q8(*jargs, n_valid, k))
    else:
        got = mips.sharded_mips_topk(pm, torch.from_numpy(q),
                                     shard_batch(pm, corpus), n_valid, k,
                                     pmask)
        want = (jmips.sharded_mips_topk_filtered(
            jm, jnp.asarray(q), jnp.asarray(corpus), jnp.asarray(mask),
            n_valid, k) if filtered else
            jmips.sharded_mips_topk(jm, jnp.asarray(q), jnp.asarray(corpus),
                                    n_valid, k))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    got = (got[0].numpy(), got[1].numpy())
    want = (np.asarray(want[0]), np.asarray(want[1]))
    assert (got[1] < n_valid).all()
    if filtered:
        assert mask[got[1]].all()
    if q8:                                   # same int products, bit-equal
        np.testing.assert_array_equal(got[0], want[0])
    _same_up_to_ties(got, want)


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("kind", ["f32", "int8", "ann"])
def test_dense_index_mesh_search_matches_jax(d, kind):
    rng = np.random.default_rng(6)
    corpus = _gauss(rng, 203)                # not a shard multiple
    ids = [f"p{i}" for i in range(203)]
    q = _gauss(rng, N_Q)
    if kind == "ann":
        kw = dict(rank=8, candidates=400)    # every shard row a candidate
        mine, theirs = DenseANNIndex(device="cpu", **kw), JANN(**kw)
    else:
        dtype = "int8" if kind == "int8" else None
        mine = DenseFlatIndex(device="cpu", **(
            {"dtype": "int8"} if dtype else {}))
        theirs = JDenseFlatIndex(**({"dtype": "int8"} if dtype else {}))
    mine.add(corpus, ids)
    theirs.add(corpus, ids)
    jm, pm = _meshes(d)
    allow = ids[::3]
    flt, jflt = DocFilter.from_ids(ids, allow), JDocFilter.from_ids(ids, allow)
    got = mine.search(q, 10, mesh=pm)
    _same_up_to_ties(got, theirs.search(q, 10, mesh=jm))
    _same_up_to_ties(got, mine.search(q, 10))
    gs, gi = mine.search_ids(q, 10, batch_size=4, mesh=pm, doc_filter=flt)
    ws, wi = theirs.search_ids(q, 10, batch_size=4, mesh=jm, doc_filter=jflt)
    for a, b, c, e in zip(gs, gi, ws, wi):
        assert set(b) <= set(allow)
        _same_up_to_ties(([a], [[ids.index(x) for x in b]]),
                         ([c], [[ids.index(x) for x in e]]))


# ---- the mesh forms of the fusion and the ranks -----------------------------

def test_fused_topk_parts_and_ranks_from_parts_match_jax():
    rng = np.random.default_rng(7)
    b, ks, kd, n = 6, 10, 8, 30
    ss = np.sort(rng.integers(0, 20, (b, ks)).astype(np.float32), 1)[:, ::-1]
    si = np.stack([rng.permutation(n)[:ks] for _ in range(b)]).astype(
        np.int32)
    ds = np.sort(rng.standard_normal((b, kd)).astype(np.float32), 1)[:, ::-1]
    di = np.stack([rng.permutation(n)[:kd] for _ in range(b)]).astype(
        np.int32)
    perm = rng.permutation(n).astype(np.int32)
    self_idx = np.full(b, -1, np.int32)
    self_idx[1] = di[1, 0]
    w_d, w_s = np.float32(0.3), np.float32(0.7)
    sp = pack_topk(torch.from_numpy(ss.copy()), torch.from_numpy(si))
    got = unpack_topk(hf.fused_topk_parts(
        sp, torch.from_numpy(ds.copy()), torch.from_numpy(di),
        torch.from_numpy(perm), torch.from_numpy(self_idx),
        torch.tensor(w_d), torch.tensor(w_s), 12).numpy())
    want = j_unpack(np.asarray(jhf.fused_topk_parts(
        j_pack(jnp.asarray(ss.copy()), jnp.asarray(si)), jnp.asarray(ds),
        jnp.asarray(di), jnp.asarray(perm), jnp.asarray(self_idx), w_d, w_s,
        12)))
    for gs, gi, ws, wi in zip(*got, *want):
        fin = np.isfinite(gs)
        np.testing.assert_allclose(gs[fin], ws[np.isfinite(ws)], atol=TOL)
        cut = gs[fin][-1] + 2 * TOL
        assert set(gi[fin][gs[fin] > cut]) <= set(wi)
    tgt = np.stack([rng.choice(di[i], 3, replace=False)
                    for i in range(b)]).astype(np.int32)
    tgt[0, 2] = -1
    for rule in ("finite", "all", "positive"):
        np.testing.assert_array_equal(
            er.ranks_from_parts(torch.from_numpy(ds.copy()),
                                torch.from_numpy(di), torch.from_numpy(tgt),
                                torch.from_numpy(self_idx), rule).numpy(),
            np.asarray(jer.ranks_from_parts(jnp.asarray(ds), jnp.asarray(di),
                                            jnp.asarray(tgt),
                                            jnp.asarray(self_idx), rule)))


# ---- encode_examples and run_search over a mesh ------------------------------

def test_encode_examples_on_a_2x2_mesh_matches_jax(setup, monkeypatch):  # noqa: F811
    """Data 2 x model 2 on the tiny anyres model, the flash route forced
    (its plain version here): the batch splits over the data axis and the
    kv heads (2 of them) over the model axis, one flash call per shard and
    layer."""
    calls = []
    plain = FA.FlashCausalAttention.apply

    def counting(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(L, "flash_attention_eligible", lambda *a: True)
    monkeypatch.setattr(FA.FlashCausalAttention, "apply", counting)
    jp, ja, jt, jtm = setup["anyres"]["j"]
    pp, pa, pt, ptm = setup["anyres"]["p"]
    ex = setup["corpus"].examples_single()[:2 * BATCH]
    jex = setup["jcorpus"].examples_single()[:2 * BATCH]
    jm, pm = _meshes(2, model=2)
    want = jencode.encode_examples(
        jex, jp, ja, jt, jtm, encode_type="image", sparse_cfg=JSparseConfig(),
        batch_size=BATCH, pixel_loader=raw_loader, mesh=jm)
    got = pencode.encode_examples(
        ex, pp, pa, pt, ptm, encode_type="image", sparse_cfg=SparseConfig(),
        batch_size=BATCH, pixel_loader=raw_loader, mesh=pm)
    assert got.ids == want.ids
    np.testing.assert_allclose(got.dense, np.asarray(want.dense), atol=TOL,
                               rtol=TOL)
    for g, w in zip(got.selected_terms, want.selected_terms):
        assert {(int(i), int(v)) for i, v in zip(g.token_ids, g.weights)
                if v > 0} == \
            {(int(i), int(v)) for i, v in zip(w.token_ids, w.weights)
             if v > 0}
    layers = pa.text.num_layers
    assert len(calls) == 2 * 2 * layers * 2       # 2 batches
    # each shard: half the batch, half the heads
    assert calls[0][0] == BATCH // 2 and calls[0][2] == pa.text.num_heads // 2
    with pytest.raises(ValueError, match="not divisible by data axis"):
        pencode.encode_examples(ex, pp, pa, pt, ptm, encode_type="image",
                                sparse_cfg=SparseConfig(), batch_size=3,
                                pixel_loader=raw_loader, mesh=pm)


@pytest.mark.parametrize("mode", ["host", "device"])
def test_run_search_on_a_mesh_matches_the_unsharded_run(setup, mode):  # noqa: F811,E501
    pp, pa, pt, ptm = setup["fixed"]["p"]
    corpus = setup["corpus"]
    docs = pencode.encode_examples(
        corpus.examples_single(), pp, pa, pt, ptm, encode_type="image",
        sparse_cfg=SparseConfig(), batch_size=BATCH, device="cpu")
    dense = DenseFlatIndex(device="cpu")
    dense.add(docs.dense, docs.ids)
    impact = ImpactIndex.from_selected_terms(docs.ids, docs.selected_terms,
                                             device="cpu")
    queries = corpus.examples_full()[:12]

    def run(mesh):
        return engine.run_search(
            queries, pp, pa, pt, ptm, query_type="text",
            sparse_cfg=SparseConfig(), search_cfg=SearchConfig(depth=10),
            dense_index=dense, impact_index=impact, batch_size=BATCH,
            get_target=lambda q: corpus.get_target(q, "text"),
            metrics=["mrr"], fusion_mode=mode, eval_mode=mode,
            device="cpu", mesh=mesh).summary()

    single = run(None)
    assert "recall" in single
    assert run(make_mesh(2, devices=["cpu"] * 2)) == single

"""PyTorch port, pipeline parallelism (``parallel/pp.py``) against the JAX
package's: ``stack_block_params`` / ``unstack_block_params``, the GPipe
``apply_pipelined`` (forward over several (pipe, data, microbatch)
layouts, gradients of the stacked blocks, LoRA and its gradients, M-RoPE
ids, a contrastive training step that learns, the refusals) and the dp x
pp x tp ``apply_pipelined_gspmd`` (forward, gradients, ``remat``), the
JAX side on the conftest's 8 virtual CPU devices, the port on meshes of
``cpu`` repeated, the same numpy-seeded inputs and weights; the JAX side
jitted. The counterpart of ``tests/test_pipeline_parallel.py``.

Tolerances (f32 on the CPU, the JAX tests' own): outputs ``atol=2e-5``
(``3e-5`` for the dp x pp x tp form), gradients ``atol=5e-4``; the specs
of ``stacked_tp_shardings`` exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.models import layers as JL
from mllm_sparse_retrieval_tpu.models import llama as jllama
from mllm_sparse_retrieval_tpu.parallel import pp as jpp
from mllm_sparse_retrieval_tpu_torch.models import llama
from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
from mllm_sparse_retrieval_tpu_torch.parallel import pp
from mllm_sparse_retrieval_tpu_torch.train.contrastive import info_nce_loss
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU8 = ["cpu"] * 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tiny(num_layers=4, batch=4, **over):
    kw = dict(vocab_size=97, hidden_size=32, num_layers=num_layers,
              num_heads=4, num_kv_heads=2, intermediate_size=64) | over
    jcfg, cfg = jllama.LlamaConfig(**kw), LlamaConfig(**kw)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(batch, 16, 32)).astype(np.float32)
    mask = np.ones((batch, 16), np.int32)
    mask[1, 10:] = 0          # ragged padding must ride with its microbatch
    mask[3, 5:] = 0
    return (jcfg, jparams), (cfg, jax.tree_util.tree_map(_t, jparams)), \
        x, mask


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_stack_unstack_roundtrip_matches_jax():
    (_, jparams), (cfg, params), _, _ = _tiny()
    stacked = pp.stack_block_params(params["blocks"])
    jstacked = jpp.stack_block_params(jparams["blocks"])
    for a, b in zip(_leaves(stacked), _leaves(jstacked)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = pp.unstack_block_params(stacked, cfg.num_layers)
    for a, b in zip(_leaves(back), _leaves(params["blocks"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pipe,data,n_micro,layers", [
    (4, 2, 2, 4), (2, 4, 4, 4), (4, 2, 4, 4), (8, 1, 2, 8), (4, 2, 2, 8)])
def test_forward_matches_jax(pipe, data, n_micro, layers):
    (jcfg, jparams), (cfg, params), x, mask = _tiny(num_layers=layers)
    jmesh = jpp.make_pp_mesh(pipe, data)
    ref = jax.jit(lambda p: jpp.apply_pipelined(
        p, jnp.asarray(x), jnp.asarray(mask), jcfg, jmesh, n_micro))(jparams)
    with torch.no_grad():
        out = pp.apply_pipelined(params, _t(x), _t(mask), cfg,
                                 pp.make_pp_mesh(pipe, data, devices=CPU8),
                                 n_micro)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def _grads_close(got, ref):
    got, ref = _leaves(got), _leaves(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-4)


def test_stacked_block_grads_match_jax():
    (jcfg, jparams), (cfg, params), x, mask = _tiny()
    probe = np.random.default_rng(1).normal(size=(4, 16, 32)).astype(
        np.float32)
    jmesh = jpp.make_pp_mesh(4, 2)
    jg = jax.jit(jax.grad(lambda st: jnp.sum(jpp.apply_pipelined(
        jparams, jnp.asarray(x), jnp.asarray(mask), jcfg, jmesh, 2,
        stacked=st) * probe)))(jpp.stack_block_params(jparams["blocks"]))
    stacked = pp.stack_block_params(params["blocks"])
    leaves = _leaves(stacked)
    for t in leaves:
        t.requires_grad_(True)
    out = pp.apply_pipelined(params, _t(x), _t(mask), cfg,
                             pp.make_pp_mesh(4, 2, devices=CPU8), 2,
                             stacked=stacked)
    grads = torch.autograd.grad((out * _t(probe)).sum(), leaves)
    _grads_close(grads, jg)


def _lora_blocks(jcfg):
    key = jax.random.PRNGKey(7)
    blocks = []
    for i in range(jcfg.num_layers):
        ks = jax.random.split(jax.random.fold_in(key, i), 4)
        h, dh = jcfg.hidden_size, jcfg.head_dim
        blocks.append({
            "q": JL.lora_init(ks[0], h, jcfg.num_heads * dh, 2, 4.0),
            "k": JL.lora_init(ks[1], h, jcfg.num_kv_heads * dh, 2, 4.0),
            "v": JL.lora_init(ks[2], h, jcfg.num_kv_heads * dh, 2, 4.0),
            "o": JL.lora_init(ks[3], jcfg.num_heads * dh, h, 2, 4.0)})
    return jax.tree_util.tree_map(lambda a: a + 0.01 * jnp.ones_like(a),
                                  blocks)


def test_lora_forward_and_grads_match_jax():
    (jcfg, jparams), (cfg, params), x, mask = _tiny()
    jblocks = _lora_blocks(jcfg)
    jmesh, mesh = jpp.make_pp_mesh(4, 2), pp.make_pp_mesh(4, 2, devices=CPU8)
    ref = jax.jit(lambda lb: jpp.apply_pipelined(
        jparams, jnp.asarray(x), jnp.asarray(mask), jcfg, jmesh, 2,
        lora={"blocks": lb}))(jblocks)
    blocks = jax.tree_util.tree_map(_t, _np(jblocks))
    with torch.no_grad():
        out = pp.apply_pipelined(params, _t(x), _t(mask), cfg, mesh, 2,
                                 lora={"blocks": blocks})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    probe = np.random.default_rng(2).normal(size=ref.shape).astype(
        np.float32)
    jg = jax.jit(jax.grad(lambda ls: jnp.sum(jpp.apply_pipelined(
        jparams, jnp.asarray(x), jnp.asarray(mask), jcfg, jmesh, 2,
        lora_stacked=ls) * probe)))(jpp.stack_block_params(jblocks))
    lstacked = pp.stack_block_params(blocks)
    leaves = _leaves(lstacked)
    for t in leaves:
        t.requires_grad_(True)
    out = pp.apply_pipelined(params, _t(x), _t(mask), cfg, mesh, 2,
                             lora_stacked=lstacked)
    _grads_close(torch.autograd.grad((out * _t(probe)).sum(), leaves), jg)


def test_mrope_position_ids_match_jax():
    (jcfg, jparams), (cfg, params), x, _ = _tiny(
        qkv_bias=True, mrope_section=(2, 1, 1))
    mask = np.ones((4, 16), np.int32)
    pos = np.random.default_rng(4).integers(0, 16, size=(3, 4, 16)).astype(
        np.int32)
    jmesh = jpp.make_pp_mesh(4, 2)
    ref = jax.jit(lambda p: jpp.apply_pipelined(
        p, jnp.asarray(x), jnp.asarray(mask), jcfg, jmesh, 2,
        position_ids=jnp.asarray(pos)))(jparams)
    with torch.no_grad():
        out = pp.apply_pipelined(params, _t(x), _t(mask), cfg,
                                 pp.make_pp_mesh(4, 2, devices=CPU8), 2,
                                 position_ids=_t(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_pipelined_training_step_learns():
    """Pipelined full-parameter contrastive Adam steps lower the loss, as
    the JAX test's jitted steps do (three here, five there)."""
    _, (cfg, params), _, _ = _tiny()
    mesh = pp.make_pp_mesh(4, 2, devices=CPU8)
    rng = np.random.default_rng(3)
    a_ids = rng.integers(1, cfg.vocab_size, size=(8, 16))
    b_ids = a_ids.copy()
    b_ids[:, ::3] = rng.integers(1, cfg.vocab_size, size=b_ids[:, ::3].shape)
    a_ids, b_ids = torch.from_numpy(a_ids), torch.from_numpy(b_ids)
    mask = torch.ones((8, 16), dtype=torch.int32)
    stacked = pp.stack_block_params(params["blocks"])
    rest = {k: v for k, v in params.items() if k != "blocks"}
    leaves = _leaves((stacked, rest))
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=1e-2)
    losses = []
    for _ in range(3):
        pr = {"final_norm": rest["final_norm"], "blocks": []}
        ya = pp.apply_pipelined(pr, llama.embed_tokens(rest, a_ids), mask,
                                cfg, mesh, 2, stacked=stacked)
        yb = pp.apply_pipelined(pr, llama.embed_tokens(rest, b_ids), mask,
                                cfg, mesh, 2, stacked=stacked)
        loss = info_nce_loss(ya.mean(dim=1), yb.mean(dim=1), tau=0.1)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_refusals_match_jax():
    (jcfg, jparams), (cfg, params), x, mask = _tiny()
    for make in (jpp.make_pp_mesh, lambda *a, **k: pp.make_pp_mesh(
            *a, devices=CPU8, **k)):
        with pytest.raises(ValueError):
            make(3)                                     # 8 % 3 != 0
    cases = [((jparams, jnp.asarray(x), jnp.asarray(mask), jcfg),
              jpp.apply_pipelined, jpp.make_pp_mesh),
             ((params, _t(x), _t(mask), cfg), pp.apply_pipelined,
              lambda *a: pp.make_pp_mesh(*a, devices=CPU8))]
    for args, apply, make in cases:
        with pytest.raises(ValueError, match="not divisible by 8"):
            apply(*args, make(8), 2)                    # 4 layers, 8 stages
        with pytest.raises(ValueError, match="n_microbatches=3"):
            apply(*args, make(4, 2), 3)                 # batch 4, 3 micro
    jpartial = {"blocks": [{"q": JL.lora_init(
        jax.random.PRNGKey(0), 32, 32, 2, 4.0)}, {}, {}, {}]}
    partial = {"blocks": [jax.tree_util.tree_map(_t, _np(
        jpartial["blocks"][0])), {}, {}, {}]}
    for (p, xx, mm, c), apply, make, lo in (
            cases[0] + (jpartial,), cases[1] + (partial,)):
        with pytest.raises(ValueError, match="EVERY block"):
            apply(p, xx, mm, c, make(4, 2), 2, lora=lo)


def test_stacked_tp_specs_match_jax():
    (_, jparams), (_, params), _, _ = _tiny()
    jmesh = jpp.make_pp3_mesh(2, 2, 2)
    mesh = pp.make_pp3_mesh(2, 2, 2, devices=CPU8)
    js = jpp.stacked_tp_shardings(jpp.stack_block_params(jparams["blocks"]),
                                  jmesh)
    ps = pp.stacked_tp_shardings(pp.stack_block_params(params["blocks"]),
                                 mesh)
    flat = jax.tree_util.tree_flatten_with_path(js)[0]
    for path, sh in flat:
        leaf = ps
        for k in path:
            leaf = leaf[k.key]
        assert leaf == tuple(sh.spec), path
    assert ps["q"]["w"] == ("pipe", None, "model")
    assert ps["down"]["w"] == ("pipe", "model", None)
    assert ps["attn_norm"]["scale"] == ("pipe",)


def _gspmd_case():
    (jcfg, jparams), (cfg, params), _, _ = _tiny()
    rng = np.random.default_rng(9)
    x = rng.normal(size=(8, 16, 32)).astype(np.float32)
    mask = np.ones((8, 16), np.int32)
    mask[1, 10:] = 0
    mask[5, 4:] = 0
    return (jcfg, jparams), (cfg, params), x, mask


@pytest.mark.parametrize("dims", [(2, 2, 2), (1, 4, 2), (2, 4, 1)])
def test_gspmd_forward_matches_jax(dims):
    (jcfg, jparams), (cfg, params), x, mask = _gspmd_case()
    jmesh = jpp.make_pp3_mesh(*dims)
    jst = jpp.stack_block_params(jparams["blocks"])
    jst = jax.device_put(jst, jpp.stacked_tp_shardings(jst, jmesh))
    with jmesh:
        ref = jax.jit(lambda st: jpp.apply_pipelined_gspmd(
            jparams, jnp.asarray(x), jnp.asarray(mask), jcfg, jmesh, 2,
            stacked=st))(jst)
    with torch.no_grad():
        out = pp.apply_pipelined_gspmd(
            params, _t(x), _t(mask), cfg,
            pp.make_pp3_mesh(*dims, devices=CPU8), 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)


def test_gspmd_grads_and_remat_match_jax():
    (jcfg, jparams), (cfg, params), x, mask = _gspmd_case()
    probe = np.random.default_rng(10).normal(size=(8, 16, 32)).astype(
        np.float32)
    jmesh = jpp.make_pp3_mesh(2, 2, 2)
    jst = jpp.stack_block_params(jparams["blocks"])
    jst = jax.device_put(jst, jpp.stacked_tp_shardings(jst, jmesh))
    with jmesh:
        jg = jax.jit(jax.grad(lambda st: jnp.sum(jpp.apply_pipelined_gspmd(
            jparams, jnp.asarray(x), jnp.asarray(mask), jcfg, jmesh, 2,
            stacked=st) * probe)))(jst)
    mesh = pp.make_pp3_mesh(2, 2, 2, devices=CPU8)
    stacked = pp.stack_block_params(params["blocks"])
    leaves = _leaves(stacked)
    for t in leaves:
        t.requires_grad_(True)
    grads = {}
    for remat in (False, True):
        out = pp.apply_pipelined_gspmd(params, _t(x), _t(mask), cfg, mesh,
                                       2, stacked=stacked, remat=remat)
        grads[remat] = torch.autograd.grad((out * _t(probe)).sum(), leaves)
        _grads_close(grads[remat], jg)
    for a, b in zip(grads[False], grads[True]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)

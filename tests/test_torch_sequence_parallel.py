"""PyTorch port, sequence parallelism (``parallel/sp.py``) against the JAX
package's: ``ring_attention`` over the chunks of a sequence against JAX's
inside its ``shard_map``, and ``apply_sequence_parallel`` (forward,
gradients, LoRA, M-RoPE ids, the refusals) against JAX's on the conftest's
8 virtual CPU devices, the port on a mesh of ``cpu`` repeated, with the
same numpy-seeded inputs and weights (the JAX tree's arrays as tensors).
The JAX side is jitted. The counterpart of
``tests/test_sequence_parallel.py``.

Tolerances (f32 on the CPU): ring attention ``atol=2e-5``, decoder outputs
``atol=3e-5`` (the JAX tests' own), gradients ``atol=5e-4`` (theirs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.models import layers as JL
from mllm_sparse_retrieval_tpu.models import llama as jllama
from mllm_sparse_retrieval_tpu.parallel import sp as jsp
from mllm_sparse_retrieval_tpu.parallel.mesh import make_mesh as jmake_mesh
from mllm_sparse_retrieval_tpu_torch.models import llama
from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
from mllm_sparse_retrieval_tpu_torch.parallel import sp
from mllm_sparse_retrieval_tpu_torch.parallel.mesh import make_mesh

CFG = dict(vocab_size=64, hidden_size=32, num_heads=4, num_kv_heads=2,
           intermediate_size=64)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tiny(num_layers=3, **over):
    jcfg = jllama.LlamaConfig(num_layers=num_layers, **CFG, **over)
    cfg = LlamaConfig(num_layers=num_layers, **CFG, **over)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 32, 32)).astype(np.float32)
    mask = np.ones((4, 32), np.int32)
    mask[1, 20:] = 0        # padding must not leak across ring steps
    mask[3, 7:] = 0         # heavy padding: whole KV chunks masked
    return (jcfg, jparams), (cfg, jax.tree_util.tree_map(_t, jparams)), \
        x, mask


def test_ring_attention_matches_jax():
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(1)
    b, t, hq, hkv, d = 2, 32, 4, 2, 8
    q = rng.normal(size=(b, t, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, t, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, t, hkv, d)).astype(np.float32)
    am = np.ones((b, t), np.int32)
    am[0, 25:] = 0
    am[1, :] = 0                      # an all-pad row: uniform, as JAX
    jmesh = jmake_mesh(data_parallel=2, model_parallel=4)
    fn = shard_map(
        lambda lq, lk, lv, lm: jsp.ring_attention(lq, lk, lv, lm, "model", 4),
        mesh=jmesh, in_specs=(P("data", "model"),) * 4,
        out_specs=P("data", "model"), check_vma=False)
    ref = np.asarray(jax.jit(fn)(*(jnp.asarray(a) for a in (q, k, v, am))))
    chunks = [list(_t(a).chunk(4, dim=1)) for a in (q, k, v, am)]
    got = torch.cat(sp.ring_attention(*chunks), dim=1).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    plain = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         JL.causal_padding_mask(jnp.asarray(am)))
    np.testing.assert_allclose(got, np.asarray(plain), atol=2e-5)


@pytest.mark.parametrize("data,model", [(2, 4), (1, 8), (4, 2)])
def test_decoder_forward_matches_jax(data, model):
    (jcfg, jparams), (cfg, params), x, mask = _tiny()
    jmesh = jmake_mesh(data_parallel=data, model_parallel=model)
    ref = jax.jit(lambda p, a, m: jsp.apply_sequence_parallel(
        p, a, m, jcfg, jmesh))(jparams, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        out = sp.apply_sequence_parallel(
            params, _t(x), _t(mask), cfg,
            make_mesh(data, model, devices=["cpu"] * 8))
        seq = llama.apply(params, _t(x), _t(mask), cfg, allow_flash=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)
    np.testing.assert_allclose(out.numpy(), seq.numpy(), atol=3e-5)


def test_grads_match_jax():
    (jcfg, jparams), (cfg, params), x, mask = _tiny()
    probe = np.random.default_rng(2).normal(size=(4, 32, 32)).astype(
        np.float32)
    jmesh = jmake_mesh(data_parallel=2, model_parallel=4)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jsp.apply_sequence_parallel(
        p, jnp.asarray(x), jnp.asarray(mask), jcfg, jmesh) * probe)))(jparams)
    leaves = jax.tree_util.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    out = sp.apply_sequence_parallel(params, _t(x), _t(mask), cfg,
                                     make_mesh(2, 4, devices=["cpu"] * 8))
    grads = torch.autograd.grad((out * _t(probe)).sum(), leaves,
                                allow_unused=True)
    ref = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(ref)
    for g, r in zip(grads, ref):
        g = torch.zeros(r.shape) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-4)


def test_lora_matches_jax():
    (jcfg, jparams), (cfg, params), x, mask = _tiny()
    key = jax.random.PRNGKey(7)
    blocks = []
    for i in range(jcfg.num_layers):
        ks = jax.random.split(jax.random.fold_in(key, i), 2)
        h, dh = jcfg.hidden_size, jcfg.head_dim
        blocks.append({
            "q": JL.lora_init(ks[0], h, jcfg.num_heads * dh, 2, 4.0),
            "down": JL.lora_init(ks[1], jcfg.intermediate_size, h, 2, 4.0)})
    blocks = jax.tree_util.tree_map(lambda a: a + 0.02 * jnp.ones_like(a),
                                    blocks)
    jmesh = jmake_mesh(data_parallel=2, model_parallel=4)
    ref = jax.jit(lambda p, lb: jsp.apply_sequence_parallel(
        p, jnp.asarray(x), jnp.asarray(mask), jcfg, jmesh,
        lora={"blocks": lb}))(jparams, blocks)
    lora = {"blocks": jax.tree_util.tree_map(_t, _np(blocks))}
    with torch.no_grad():
        out = sp.apply_sequence_parallel(
            params, _t(x), _t(mask), cfg,
            make_mesh(2, 4, devices=["cpu"] * 8), lora=lora)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)


def test_mrope_position_ids_match_jax():
    (jcfg, jparams), (cfg, params), x, mask = _tiny(
        num_layers=2, qkv_bias=True, mrope_section=(2, 1, 1))
    mask = np.ones_like(mask)
    mask[2, 25:] = 0
    pos = np.random.default_rng(5).integers(0, 32, size=(3, 4, 32)).astype(
        np.int32)
    jmesh = jmake_mesh(data_parallel=2, model_parallel=4)
    ref = jax.jit(lambda p: jsp.apply_sequence_parallel(
        p, jnp.asarray(x), jnp.asarray(mask), jcfg, jmesh,
        position_ids=jnp.asarray(pos)))(jparams)
    with torch.no_grad():
        out = sp.apply_sequence_parallel(
            params, _t(x), _t(mask), cfg,
            make_mesh(2, 4, devices=["cpu"] * 8), position_ids=_t(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)


def test_refusals_match_jax():
    from mllm_sparse_retrieval_tpu.parallel import ep as jep
    from mllm_sparse_retrieval_tpu_torch.parallel import ep

    (jcfg, jparams), (cfg, params), x, mask = _tiny()
    jmesh = jmake_mesh(data_parallel=2, model_parallel=4)
    mesh = make_mesh(2, 4, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="not divisible"):
        jsp.apply_sequence_parallel(jparams, jnp.asarray(x[:, :30]),
                                    jnp.asarray(mask[:, :30]), jcfg, jmesh)
    with pytest.raises(ValueError, match="not divisible"):
        sp.apply_sequence_parallel(params, _t(x[:, :30]), _t(mask[:, :30]),
                                   cfg, mesh)
    jmoe = jllama.LlamaConfig(num_layers=1, moe=jep.MoEConfig(), **CFG)
    moe = LlamaConfig(num_layers=1, moe=ep.MoEConfig(), **CFG)
    with pytest.raises(ValueError, match="dense-FFN"):
        jsp.apply_sequence_parallel(jparams, jnp.asarray(x),
                                    jnp.asarray(mask), jmoe, jmesh)
    with pytest.raises(ValueError, match="dense-FFN"):
        sp.apply_sequence_parallel(params, _t(x), _t(mask), moe, mesh)

"""PyTorch port, the mixture-of-experts FFN (``parallel/ep.py``) and MoE
decoders (``models/llama.py`` with ``LlamaConfig.moe``) against the JAX
package on the same seeded inputs and weights (carried across with
``from_jax_params``), on the CPU.

The port seats assignments with index operations where the JAX package
builds one-hot ``[N, E, C]`` tensors; the tests turn the port's routing
into those tensors and compare them exactly. Tolerances (f32): dispatch,
seats, kept and dropped assignments and tie order exact; gates, combine
weights and the aux loss within ``atol=rtol=1e-6``; FFN outputs, decoder
hidden states and aux within ``atol=rtol=1e-5`` (the expert products sum
in another order); gradients against ``jax.grad`` within
``atol=rtol=1e-4`` (backward products through two blocks). Routing is a
discrete choice: the seeded inputs were checked to have no near-tie
between the k-th and (k+1)-th probability, so both packages seat alike.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.models import convert as jconvert
from mllm_sparse_retrieval_tpu.models import llama as jllama
from mllm_sparse_retrieval_tpu.models import lora as jlora
from mllm_sparse_retrieval_tpu.models import mllm as jmllm
from mllm_sparse_retrieval_tpu.models.llama import LlamaConfig as JLlama
from mllm_sparse_retrieval_tpu.models.mllm import MLLMConfig as JMLLM
from mllm_sparse_retrieval_tpu.models.vit import ViTConfig as JViT
from mllm_sparse_retrieval_tpu.parallel import ep as jep
from mllm_sparse_retrieval_tpu_torch.models import convert, llama, lora, mllm
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import from_jax_params
from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
from mllm_sparse_retrieval_tpu_torch.models.mllm import MLLMConfig
from mllm_sparse_retrieval_tpu_torch.models.vit import ViTConfig
from mllm_sparse_retrieval_tpu_torch.parallel import ep
from tests.torch_threads import one_torch_thread  # noqa: F401

EXACT_TOL = dict(atol=1e-6, rtol=1e-6)
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
TEXT = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=48, rope_theta=10000.0)


def _probs(seed, n, e):
    logits = np.random.default_rng(seed).standard_normal((n, e)) * 2.0
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _dense(r: ep.Routing, e, capacity):
    """The port's routing as the JAX package's [N, E, C] dispatch and
    combine tensors."""
    n, k = r.expert.shape
    dispatch = np.zeros((n, e, capacity), np.float32)
    combine = np.zeros((n, e, capacity), np.float32)
    for t in range(n):
        for s in range(k):
            if r.keep[t, s]:
                ex, seat = int(r.expert[t, s]), int(r.seat[t, s])
                dispatch[t, ex, seat] += 1.0
                combine[t, ex, seat] += float(r.gate[t, s])
    return dispatch, combine


def _cfgs():
    return [(k, norm) for k in (1, 2) for norm in (True, False)]


@pytest.mark.parametrize("top_k,normalize", _cfgs())
@pytest.mark.parametrize("capacity", [None, 8])
def test_dispatch_combine_matches_jax(top_k, normalize, capacity):
    """Seats, drops (capacity 8 overflows: 40 tokens on 4 experts), gates
    and the aux loss against the JAX one-hot tensors."""
    n, e = 40, 4
    cfg = ep.MoEConfig(num_experts=e, top_k=top_k, normalize_gates=normalize)
    jcfg = jep.MoEConfig(num_experts=e, top_k=top_k,
                         normalize_gates=normalize)
    assert ep.expert_capacity(n, cfg) == jep.expert_capacity(n, jcfg)
    cap = capacity or ep.expert_capacity(n, cfg)
    probs = _probs(top_k * 10 + normalize, n, e)
    jd, jc, jaux = jep._dispatch_combine(jnp.asarray(probs), jcfg, cap)
    r = ep._dispatch_combine(torch.from_numpy(probs), cfg, cap)
    d, c = _dense(r, e, cap)
    np.testing.assert_array_equal(d, np.asarray(jd))
    np.testing.assert_allclose(c, np.asarray(jc), **EXACT_TOL)
    np.testing.assert_allclose(float(r.aux), float(jaux), **EXACT_TOL)
    if capacity:
        assert (~r.keep).any()        # overflow dropped something
        assert int(r.keep.sum()) == int(np.asarray(jd).sum())


def test_top_k_breaks_ties_like_lax_top_k():
    """Exact ties in the probabilities: the lower expert index first, as
    ``lax.top_k`` orders them."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2],
                      [0.0, 0.5, 0.0, 0.5]], np.float32)
    cfg = ep.MoEConfig(num_experts=4, top_k=2)
    r = ep._dispatch_combine(torch.from_numpy(probs), cfg, 8)
    _, want = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(r.expert.numpy(), np.asarray(want))
    jd, _, _ = jep._dispatch_combine(jnp.asarray(probs),
                                     jep.MoEConfig(num_experts=4, top_k=2), 8)
    np.testing.assert_array_equal(_dense(r, 4, 8)[0], np.asarray(jd))


@pytest.mark.parametrize("capacity", [1.25, 0.5])
@pytest.mark.parametrize("top_k,normalize", _cfgs())
def test_moe_ffn_matches_jax(top_k, normalize, capacity):
    h, f, e = 32, 48, 4
    cfg = ep.MoEConfig(num_experts=e, top_k=top_k, normalize_gates=normalize,
                       capacity_factor=capacity)
    jcfg = jep.MoEConfig(num_experts=e, top_k=top_k,
                         normalize_gates=normalize, capacity_factor=capacity)
    jp = jep.moe_init(jax.random.PRNGKey(top_k), h, f, jcfg)
    assert jp["router"].dtype == jnp.float32
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(3).standard_normal((3, 16, h)).astype(
        np.float32)
    jy, jaux = jep.moe_ffn(jnp.asarray(x), jp, jcfg)
    y, aux = ep.moe_ffn(torch.from_numpy(x), p, cfg)
    assert y.shape == (3, 16, h)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_pad_heavy_batch_takes_seats_and_drops_like_jax():
    """Pad rows (one repeated vector, as pad embeddings are) are routed and
    crowd their experts: the real tokens behind them are dropped alike."""
    h, f, e = 32, 48, 4
    jcfg = jep.MoEConfig(num_experts=e, top_k=2)
    cfg = ep.MoEConfig(num_experts=e, top_k=2)
    jp = jep.moe_init(jax.random.PRNGKey(7), h, f, jcfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(4)
    x = np.repeat(rng.standard_normal((1, 1, h)), 48, axis=1)
    x[:, :8] = rng.standard_normal((1, 8, h))          # 8 real, 40 pad
    x[:, 40:] = rng.standard_normal((1, 8, h))         # 8 real after them
    x = x.astype(np.float32)
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, h) @ p["router"],
                          dim=-1)
    r = ep._dispatch_combine(probs, cfg, ep.expert_capacity(48, cfg))
    assert (~r.keep).sum() >= 10                       # pads overflow
    jy, jaux = jep.moe_ffn(jnp.asarray(x), jp, jcfg)
    y, aux = ep.moe_ffn(torch.from_numpy(x), p, cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def _moe_decoder(seed=0):
    jcfg = JLlama(**TEXT, moe=jep.MoEConfig(num_experts=4, top_k=2))
    cfg = LlamaConfig(**TEXT, moe=ep.MoEConfig(num_experts=4, top_k=2))
    jparams = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")["text"]
    return jcfg, jparams, cfg, params


def _inputs(b=2, t=12, h=32, seed=5):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((b, t, h)).astype(np.float32)
    mask = np.ones((b, t), np.int32)
    mask[1, 8:] = 0
    return emb, mask


@pytest.mark.parametrize("remat", [False, True])
def test_moe_decoder_and_gradients_match_jax(remat):
    jcfg, jparams, cfg, params = _moe_decoder()
    assert set(params["blocks"][0]) == set(jparams["blocks"][0])
    assert "gate" not in params["blocks"][0]
    emb, mask = _inputs()
    r = np.random.default_rng(6).standard_normal(emb.shape).astype(
        np.float32)

    def jloss(jp):
        hid, aux = jllama.apply(jp, jnp.asarray(emb), jnp.asarray(mask),
                                jcfg, remat=remat)
        return jnp.sum(hid * r) + 0.5 * aux, (hid, aux)

    (jl, (jh, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = [x.requires_grad_(True) for x in lora.tree_leaves(params)]
    hid, aux = llama.apply(params, torch.from_numpy(emb),
                           torch.from_numpy(mask), cfg, remat=remat)
    loss = (hid * torch.from_numpy(r)).sum() + 0.5 * aux
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    np.testing.assert_allclose(hid.detach().numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **TOL)
    assert float(aux.detach()) > 0
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(grads)
    for g, jgl in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgl), **GRAD_TOL)
    moe_grads = grads[:len(lora.tree_leaves(params["blocks"][0]))]
    assert all(float(g.abs().sum()) > 0 for g in moe_grads)


def test_dense_config_keeps_its_return_value():
    cfg = LlamaConfig(**TEXT)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                               torch.float32)
    emb, mask = _inputs()
    out = llama.apply(params, torch.from_numpy(emb), torch.from_numpy(mask),
                      cfg)
    assert isinstance(out, torch.Tensor) and out.shape == emb.shape


def test_init_params_draws_experts_in_place_of_the_dense_ffn():
    cfg = LlamaConfig(**TEXT, moe=ep.MoEConfig(num_experts=4, top_k=2))
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                               torch.bfloat16)
    blk = params["blocks"][1]
    assert not {"gate", "up", "down"} & set(blk)
    m = blk["moe"]
    assert m["router"].dtype == torch.float32
    assert (m["gate"].shape, m["up"].shape, m["down"].shape) == \
        ((4, 32, 48), (4, 32, 48), (4, 48, 32))
    assert m["down"].dtype == torch.bfloat16


def _moe_arch(jax_side):
    if jax_side:
        return JMLLM(vision=JViT(image_size=28, patch_size=14,
                                 hidden_size=32, num_layers=2, num_heads=4),
                     text=JLlama(**TEXT, moe=jep.MoEConfig(num_experts=4)),
                     image_token_id=4)
    return MLLMConfig(vision=ViTConfig(image_size=28, patch_size=14,
                                       hidden_size=32, num_layers=2,
                                       num_heads=4),
                      text=LlamaConfig(**TEXT,
                                       moe=ep.MoEConfig(num_experts=4)),
                      image_token_id=4)


def test_init_lora_skips_moe_blocks_like_jax():
    jarch = _moe_arch(True)
    jparams = jmllm.init_params(jax.random.PRNGKey(0), jarch)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    jad = jlora.init_lora(jax.random.PRNGKey(1), jparams, jarch, rank=2)
    ad = lora.init_lora(torch.Generator().manual_seed(1), params,
                        _moe_arch(False), rank=2, device="cpu")
    assert [sorted(b) for b in ad["text"]["blocks"]] == \
        [sorted(b) for b in jad["text"]["blocks"]] == [["k", "o", "q", "v"]] * 2
    for blk, jblk in zip(ad["text"]["blocks"], jad["text"]["blocks"]):
        for name in blk:
            assert blk[name]["a"].shape == jblk[name]["a"].shape
            assert blk[name]["b"].shape == jblk[name]["b"].shape


def test_mllm_wrapper_refuses_moe_like_jax():
    jarch = _moe_arch(True)
    jparams = jmllm.init_params(jax.random.PRNGKey(0), jarch)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    ids = np.full((1, 6), 7, np.int32)
    mask = np.ones((1, 6), np.int32)
    with pytest.raises(ValueError, match="MoE") as jerr:
        jmllm.forward_hidden(jparams, jarch, jnp.asarray(ids),
                             jnp.asarray(mask))
    with pytest.raises(ValueError, match="MoE") as err:
        mllm.forward_hidden(params, _moe_arch(False), torch.from_numpy(ids),
                            torch.from_numpy(mask))
    assert str(err.value) == str(jerr.value)


def test_moe_manifest_reads_back_as_jax_reads_it():
    """``arch_to_manifest`` writes the MoE config as a dict; read back, both
    packages keep that dict (the field's annotation is a string under
    ``from __future__ import annotations``, so no dataclass is rebuilt)."""
    text = json.dumps(convert.arch_to_manifest(_moe_arch(False)))
    assert text == json.dumps(jconvert.arch_to_manifest(_moe_arch(True)))
    manifest = json.loads(text)
    got = convert.arch_from_manifest(manifest).text.moe
    want = jconvert.arch_from_manifest(manifest).text.moe
    assert isinstance(got, dict) and got == want == {
        "num_experts": 4, "top_k": 2, "capacity_factor": 1.25,
        "aux_loss_coef": 0.01, "normalize_gates": True}

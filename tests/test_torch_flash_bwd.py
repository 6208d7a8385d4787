"""PyTorch port, flash attention backward on the CPU: ``FlashCausalAttention``
(on the CPU its forward is the plain version and its backward autograd
through it) and ``flash_causal_attention_plain_bwd`` against ``jax.vjp`` of
the JAX package's ``layers.attention`` + ``causal_padding_mask``, on seeded
numpy inputs: T = 1,024, head_dim 128, GQA (dk/dv summed over each group),
right padding, an all-pad row and a random output gradient. The dq and dkv
kernels themselves run only on the card (``tests/test_torch_cuda.py``).

Compared: dq at every query that has a real key at or before it; dk and dv
of every batch row that holds a real token. An all-pad row is where the two
differ by design: JAX attends uniformly over all T keys there (every logit
is ``finfo.min``), so its keys get gradient; the port gives that row an
output of 0 and all three gradients 0, which is checked.

Tolerances (f32): ``atol=rtol=1e-5`` (XLA and PyTorch sum in different
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.models import layers as JL
from mllm_sparse_retrieval_tpu_torch.models import layers as L
from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, b, t, hq, hkv, dh, lengths):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, t, h, dh)).astype(np.float32)
               for h in (hq, hkv, hkv))
    dout = rng.normal(size=(b, t, hq, dh)).astype(np.float32)
    mask = np.zeros((b, t), np.int32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1
    return q, k, v, mask, dout


def _jax_grads(q, k, v, mask, dout):
    m = JL.causal_padding_mask(jnp.asarray(mask))
    _, vjp = jax.vjp(lambda a, b, c: JL.attention(a, b, c, m),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("shape", [
    # (b, t, hq, hkv, dh, lengths)
    (3, 1024, 4, 2, 128, (1024, 617, 0)),
    (2, 200, 4, 4, 32, (137, 200)),
])
def test_function_backward_matches_jax_vjp(shape):
    b, t, hq, hkv, dh, lengths = shape
    q, k, v, mask, dout = _case(0, b, t, hq, hkv, dh, lengths)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    before = {n: FA.launch_count(n) for n in FA.KERNELS}
    out = FA.FlashCausalAttention.apply(*leaves, _t(mask), None)
    out.backward(_t(dout))
    assert {n: FA.launch_count(n) for n in FA.KERNELS} == before
    got = [x.grad.numpy() for x in leaves]
    ref = _jax_grads(q, k, v, mask, dout)
    rows = np.cumsum(mask, axis=1) > 0           # queries with a real key
    real_b = mask.any(axis=1)                    # batch rows with a token
    np.testing.assert_allclose(got[0][rows], ref[0][rows], **TOL)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g[real_b], r[real_b], **TOL)
    for g in got:
        assert (g[~real_b] == 0).all()
    # the plain backward is the same autograd computation
    plain = FA.flash_causal_attention_plain_bwd(*map(_t, (q, k, v, mask,
                                                          dout)))
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p.numpy())


def test_layers_route_differentiates_through_the_function():
    q, k, v, mask, dout = _case(1, 2, 64, 4, 2, 16, (64, 30))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = L.flash_causal_attention(*leaves, _t(mask), scale=0.3)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ == "FlashCausalAttentionBackward"
    grads = torch.autograd.grad(out, leaves, _t(dout))
    ref = FA.flash_causal_attention_plain_bwd(
        *map(_t, (q, k, v, mask, dout)), scale=0.3)
    for g, r in zip(grads, ref):
        assert torch.equal(g, r)


def test_backward_magnitudes_bound_the_terms():
    q, k, v, mask, dout = _case(2, 2, 96, 4, 2, 16, (96, 40))
    mq, mk, mv = FA.flash_bwd_magnitudes(*map(_t, (q, k, v, mask, dout)))
    dq, dk, dv = FA.flash_causal_attention_plain_bwd(
        *map(_t, (q, k, v, mask, dout)))
    for g, m in ((dq, mq), (dk, mk), (dv, mv)):
        assert g.shape == m.shape and m.dtype == torch.float32
        assert bool((g.abs() <= m + 1e-6).all())
    assert float(mk[1, 40:].abs().max()) == 0.0    # pad keys: no terms

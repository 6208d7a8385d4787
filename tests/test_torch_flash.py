"""PyTorch port, flash attention on the CPU: the plain version of the flash
kernel against the JAX package's ``layers.attention`` +
``causal_padding_mask``, ``llama.apply`` with the flash route forced against
JAX ``llama.apply``, and ``mllm.encode`` at ``AFTER_PAD`` with the flash
route forced against JAX ``encode``, on seeded inputs and weights carried
across with ``from_jax_params``. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).

The flash route's rule: key ``s`` is admissible for query ``t`` iff
``s <= t`` and ``mask[b, s]`` is set, which equals ``causal_padding_mask``
at every query that has a real key at or before it, pad queries included.
A query with none (an all-pad row) gets 0 from the port's plain version and
kernel, and the uniform average of ``v`` over all ``T`` keys from JAX (every
logit of the row is ``finfo.min``); such rows are checked to be 0, not
compared.

Tolerances (f32 on the CPU): ``atol=rtol=1e-5`` at every compared position
(XLA and PyTorch sum the logits and the P V product in different orders);
``1e-4`` on sparse logits (the LM head adds a hidden-size-long dot product).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.configs import ModelConfig as JModelConfig
from mllm_sparse_retrieval_tpu.configs import RepsLoc as JRepsLoc
from mllm_sparse_retrieval_tpu.models import layers as JL
from mllm_sparse_retrieval_tpu.models import llama as jllama
from mllm_sparse_retrieval_tpu.models import mllm as jmllm
from mllm_sparse_retrieval_tpu.models.registry import (
    tiny_debug_arch as j_tiny_arch)
from mllm_sparse_retrieval_tpu_torch.configs import ModelConfig, RepsLoc
from mllm_sparse_retrieval_tpu_torch.models import layers as L
from mllm_sparse_retrieval_tpu_torch.models import llama, mllm
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import from_jax_params
from mllm_sparse_retrieval_tpu_torch.models.registry import tiny_debug_arch
from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, b, t, hq, hkv, dh, lengths):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, hq, dh)).astype(np.float32)
    k = rng.normal(size=(b, t, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, t, hkv, dh)).astype(np.float32)
    mask = np.zeros((b, t), np.int32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1
    return q, k, v, mask


def _jax_attention(q, k, v, mask):
    return np.asarray(JL.attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v),
                                   JL.causal_padding_mask(jnp.asarray(mask))))


def _has_key(mask):
    """[B, T] bool: the query has a real key at or before it."""
    return np.cumsum(np.asarray(mask) != 0, axis=1) > 0


@pytest.mark.parametrize("shape", [
    # (b, t, hq, hkv, dh, lengths): the eligible shape with GQA and ragged
    # right padding, an all-pad row, MHA, a chunked plain version
    (3, 1024, 4, 2, 128, (1024, 617, 0)),
    (2, 96, 4, 4, 32, (96, 50)),
    (2, 300, 6, 2, 16, (1, 299)),
])
def test_flash_plain_matches_jax_attention(shape, monkeypatch):
    b, t, hq, hkv, dh, lengths = shape
    q, k, v, mask = _qkv(0, b, t, hq, hkv, dh, lengths)
    if t == 300:
        monkeypatch.setattr(FA, "_PLAIN_CHUNK_ELEMS", 3 * 70 * t)
    got = FA.flash_causal_attention_plain(_t(q), _t(k), _t(v), _t(mask))
    ref = _jax_attention(q, k, v, mask)
    rows = _has_key(mask)             # pad rows of a real prompt included
    assert rows.sum() > np.asarray(mask).sum() or 0 in lengths
    np.testing.assert_allclose(got.numpy()[rows], ref[rows], **TOL)
    assert torch.isfinite(got).all()
    assert (got.numpy()[~rows] == 0).all()
    assert got.shape == (b, t, hq, dh)


def test_flash_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v, mask = _qkv(1, 2, 64, 4, 2, 16, (64, 30))
    before = FA.launch_count()
    got = L.flash_causal_attention(_t(q), _t(k), _t(v), _t(mask), scale=0.3)
    ref = FA.flash_causal_attention_plain(_t(q), _t(k), _t(v), _t(mask),
                                          scale=0.3)
    assert torch.equal(got, ref)
    assert FA.launch_count() == before        # no kernel on the CPU


def test_tma_view_copies_only_broadcast_inputs():
    """The kernels read through TMA tensor maps, which take no zero stride:
    a broadcast input is copied, every other view passed as it is."""
    x = torch.arange(2 * 6 * 3 * 8, dtype=torch.float32).reshape(2, 6, 3, 8)
    assert FA._tma_view(x) is x
    head = x[:, :, 1:2]                     # extent-1 head: no copy needed
    assert FA._tma_view(head) is head
    wide = x[:, :, :2]                      # strided view: read in place
    assert FA._tma_view(wide) is wide
    bcast = x[:1].expand(2, -1, -1, -1)     # batch stride 0
    got = FA._tma_view(bcast)
    assert got is not bcast and got.is_contiguous()
    assert torch.equal(got, bcast)


def test_flash_inputs_are_checked():
    q, k, v, mask = _qkv(3, 1, 16, 4, 2, 8, (16,))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        FA.flash_causal_attention(_t(q)[:, :, :3], _t(k), _t(v), _t(mask))
    with pytest.raises(ValueError, match=r"\[B, T\]"):
        FA.flash_causal_attention(_t(q), _t(k), _t(v), _t(mask)[:, :8])
    with pytest.raises(ValueError, match="do not match"):
        FA.flash_causal_attention(_t(q), _t(k)[:, :8], _t(v), _t(mask))
    with pytest.raises(TypeError, match="dtypes"):
        FA.flash_causal_attention(_t(q), _t(k).double(), _t(v), _t(mask))


def test_flash_gate_mirrors_jax_shape_conditions():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for t, dh in [(1024, 128), (3072, 128), (1536, 256), (1000, 128),
                  (1100, 128), (512, 128), (2048, 64), (4096, 96)]:
        # the JAX gate's conditions, except that head_dim is exactly 128:
        # the kernel's only width (JAX admits any multiple of 128)
        want = t >= JL.FLASH_MIN_SEQ and t % 512 == 0 and dh == 128
        assert L.flash_attention_eligible(t, dh, cuda) == want
        assert not L.flash_attention_eligible(t, dh, cpu)
    assert L.FLASH_MIN_SEQ == JL.FLASH_MIN_SEQ


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def tower():
    cfg = dict(tiny_vocab_size=256, tiny_hidden_size=64, tiny_num_layers=2,
               tiny_num_heads=4)
    jarch = j_tiny_arch(JModelConfig(dtype="float32", **cfg))
    arch = tiny_debug_arch(ModelConfig(dtype="float32", **cfg))
    jparams = jmllm.init_params(jax.random.PRNGKey(0), jarch, jnp.float32)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return jarch, arch, jparams, params


@pytest.mark.parametrize("t", [48, 512])
def test_llama_apply_with_flash_forced_matches_jax(tower, monkeypatch, t):
    jarch, arch, jparams, params = tower
    rng = np.random.default_rng(8)
    emb = rng.normal(size=(3, t, 64)).astype(np.float32)
    mask = np.ones((3, t), np.int32)
    mask[1, t // 3:] = 0
    mask[2, 5:] = 0
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        return FA.flash_causal_attention(*a, **kw)

    monkeypatch.setattr(L, "flash_attention_eligible", lambda *a: True)
    monkeypatch.setattr(L, "flash_causal_attention", spy)
    got = llama.apply(params["text"], _t(emb), _t(mask), arch.text)
    assert len(calls) == arch.text.num_layers
    ref = np.asarray(jllama.apply(jparams["text"], jnp.asarray(emb),
                                  jnp.asarray(mask), jarch.text))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)   # pad rows too
    assert torch.isfinite(got).all()
    # allow_flash=False forces the plain masked attention
    calls.clear()
    plain = llama.apply(params["text"], _t(emb), _t(mask), arch.text,
                        allow_flash=False)
    assert calls == []
    np.testing.assert_allclose(plain.numpy(), ref, **TOL)


@pytest.mark.parametrize("gqa", [False, True])
def test_encode_after_pad_with_flash_forced_matches_jax(monkeypatch, gqa):
    """``AFTER_PAD`` reads position T-1, a pad row of every right-padded
    prompt: on the flash route it must see the prompt, as JAX's does."""
    cfg = dict(tiny_vocab_size=256, tiny_hidden_size=64, tiny_num_layers=2,
               tiny_num_heads=4)
    jarch = j_tiny_arch(JModelConfig(dtype="float32", **cfg))
    arch = tiny_debug_arch(ModelConfig(dtype="float32", **cfg))
    if gqa:
        jarch = dataclasses.replace(jarch, text=dataclasses.replace(
            jarch.text, num_kv_heads=2))
        arch = dataclasses.replace(arch, text=dataclasses.replace(
            arch.text, num_kv_heads=2))
    jparams = jmllm.init_params(jax.random.PRNGKey(3), jarch, jnp.float32)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    rng = np.random.default_rng(9)
    ids = rng.integers(5, 256, size=(3, 64)).astype(np.int32)
    mask = np.zeros((3, 64), np.int32)
    for i, n in enumerate((40, 64, 7)):
        mask[i, :n] = 1
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        return FA.flash_causal_attention(*a, **kw)

    monkeypatch.setattr(L, "flash_attention_eligible", lambda *a: True)
    monkeypatch.setattr(L, "flash_causal_attention", spy)
    sparse, dense = mllm.encode(params, arch, _t(ids).long(), _t(mask),
                                reps_loc=RepsLoc.AFTER_PAD)
    assert len(calls) == arch.text.num_layers
    jsparse, jdense = jmllm.encode(jparams, jarch, jnp.asarray(ids),
                                   jnp.asarray(mask), None,
                                   JRepsLoc.AFTER_PAD)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), **TOL)
    np.testing.assert_allclose(sparse.numpy(), np.asarray(jsparse),
                               atol=1e-4, rtol=1e-4)
    # two prompts that differ only in their real tokens differ at T-1
    ids2 = ids.copy()
    ids2[0, :40] = rng.integers(5, 256, size=40)
    _, dense2 = mllm.encode(params, arch, _t(ids2).long(), _t(mask),
                            reps_loc=RepsLoc.AFTER_PAD)
    assert float((dense2[0] - dense[0]).abs().max()) > 1e-3

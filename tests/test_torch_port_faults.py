"""PyTorch port: two faults found against the JAX package, each with the
test that caught it, and the bound of a documented deviation.

- ``FusedHybridSearcher`` (and so the hybrid ``RetrievalService`` and
  ``run_search(fusion_mode="device")``) refused two spellings of one
  device, ``cpu`` and ``cpu:0`` here (``cuda`` and ``cuda:0`` on a card),
  because ``torch.device`` objects compare their spelling.
- ``layers.dense`` keeps the LoRA path's output in the base weights' dtype
  (bf16 on the card) where the JAX package promotes the residual stream to
  f32 from the first adapted projection. Keeping the rule is deliberate:
  f32 activations would not reach the bf16-only flash kernel.
  ``test_bf16_lora_tower_stays_within_its_bound`` measures the gap on a
  2-layer text tower with bf16 weights and f32 adapters, the port against
  the JAX package (whose CPU backend runs bf16). Measured on this seed:
  max |port - JAX| / max |JAX| = 0.0139 for the dense reps and 0.0297 for
  the sparse logits (3.6 and 7.6 bf16 unit roundoffs ``2^-8``); each
  package's own gap to the f32 tower was 0.0152 / 0.0288 (port) and
  0.0078 / 0.0156 (JAX). Bounds: ``2^-5`` (dense) and ``2^-4`` (sparse)
  of max |JAX|, and the port's gap to the f32 tower at most 4 times the
  JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.configs import ModelConfig as JModelConfig
from mllm_sparse_retrieval_tpu.configs import RepsLoc as JRepsLoc
from mllm_sparse_retrieval_tpu.models import api as japi
from mllm_sparse_retrieval_tpu.models import lora as jlora
from mllm_sparse_retrieval_tpu.models import mllm as jmllm
from mllm_sparse_retrieval_tpu.models.registry import (
    tiny_debug_arch as j_tiny_arch)
from mllm_sparse_retrieval_tpu_torch.configs import ModelConfig, RepsLoc
from mllm_sparse_retrieval_tpu_torch.index import (
    DenseFlatIndex, ImpactIndex)
from mllm_sparse_retrieval_tpu_torch.models import api
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import (
    from_jax_lora, from_jax_params)
from mllm_sparse_retrieval_tpu_torch.models.registry import tiny_debug_arch
from mllm_sparse_retrieval_tpu_torch.search.device_fusion import (
    FusedHybridSearcher)
from mllm_sparse_retrieval_tpu_torch.serving import RetrievalService

TINY = dict(tiny_vocab_size=256, tiny_hidden_size=64, tiny_num_layers=2,
            tiny_num_heads=4)
DENSE_BOUND, SPARSE_BOUND, F32_GAP_RATIO = 2.0 ** -5, 2.0 ** -4, 4.0


def _indexes(dense_device, impact_device):
    rng = np.random.default_rng(0)
    ids = [f"d{i}" for i in range(30)]
    dense = DenseFlatIndex(device=dense_device)
    dense.add(rng.standard_normal((30, 8)).astype(np.float32), ids)
    impact = ImpactIndex(device=impact_device)
    for i, d in enumerate(ids):
        impact.add(d, {i % 7: 1 + i, (i + 3) % 7: 2})
    impact.finalize()
    return dense, impact


@pytest.mark.parametrize("devices", [("cpu", "cpu:0"), ("cpu:0", "cpu")])
def test_hybrid_takes_two_spellings_of_one_device(devices):
    dense, impact = _indexes(*devices)
    fused = FusedHybridSearcher(dense, impact)
    q = np.random.default_rng(1).standard_normal((2, 8)).astype(np.float32)
    q_idx, q_w = impact.encode_queries([{1: 3}, {4: 2, 5: 1}])
    scores, ids = fused.search_encoded(q, q_idx, q_w, 5)
    want = FusedHybridSearcher(*_indexes("cpu", "cpu")).search_encoded(
        q, q_idx, q_w, 5)
    assert (scores, ids) == want and len(ids[0]) == 5
    svc = RetrievalService(dense, impact, max_batch=2, depth_levels=(5,),
                           default_depth=5, max_wait_ms=1.0)
    try:
        got = svc.search(terms={1: 3}, dense=q[0], depth=5, timeout=60)
    finally:
        svc.close()
    assert [d for d, _ in got] == ids[0]


def test_other_devices_still_refused():
    dense, impact = _indexes("cpu", "cpu")
    impact.device = torch.device("meta")
    with pytest.raises(ValueError, match="one device"):
        FusedHybridSearcher(dense, impact)


def _adapters(jparams, jarch, seed):
    """A JAX text-adapter tree with random nonzero ``b`` (f32), and its
    port copy."""
    tree = jax.tree_util.tree_map(np.asarray, jlora.init_lora(
        jax.random.PRNGKey(seed), jparams, jarch, rank=4, alpha=8.0,
        train_vision=False, train_projector=False))
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, dict) and "b" in node:
            node["b"] = (0.1 * rng.normal(size=node["b"].shape)).astype(
                np.float32)
            return
        for child in (node.values() if isinstance(node, dict) else node):
            fill(child)

    fill(tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), from_jax_lora(tree,
                                                                    "cpu")


def test_bf16_lora_tower_stays_within_its_bound():
    jarch = j_tiny_arch(JModelConfig(dtype="float32", **TINY))
    arch = tiny_debug_arch(ModelConfig(dtype="float32", **TINY))
    assert arch.text.num_layers == 2
    jparams = jmllm.init_params(jax.random.PRNGKey(0), jarch, jnp.float32)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    jad, ad = _adapters(jparams, jarch, 4)
    jp16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jparams)
    p16 = from_jax_params(np_tree, "cpu", dtype=torch.bfloat16)
    p32 = from_jax_params(np_tree, "cpu")
    rng = np.random.default_rng(4)
    ids = rng.integers(5, 256, size=(3, 16)).astype(np.int32)
    mask = np.ones((3, 16), np.int32)
    mask[1, 11:] = 0
    mask[2, 5:] = 0
    t_ids, t_mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    with torch.no_grad():
        port = api.encode_any(p16, arch, t_ids, t_mask, None,
                              RepsLoc.BEFORE_PAD, ad)
        full = api.encode_any(p32, arch, t_ids, t_mask, None,
                              RepsLoc.BEFORE_PAD, ad)
    ref = japi.encode_any(jp16, jarch, jnp.asarray(ids), jnp.asarray(mask),
                          None, JRepsLoc.BEFORE_PAD, jad)
    # the port's residual stream stays bf16; the JAX package's turns f32
    assert port[1].dtype == torch.bfloat16 and ref[1].dtype == jnp.float32
    for got, want, f32, bound in zip(port, ref, full,
                                     (SPARSE_BOUND, DENSE_BOUND)):
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        f32 = f32.numpy()
        scale = np.abs(want).max()
        assert np.isfinite(got).all() and scale > 0
        assert np.abs(got - want).max() <= bound * scale
        assert np.abs(got - f32).max() <= \
            F32_GAP_RATIO * np.abs(want - f32).max()

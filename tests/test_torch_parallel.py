"""PyTorch port, the parallel layouts against the JAX package's: the spec
trees of ``tp_param_shardings``, ``fsdp_shardings`` (alone and on a
tensor-parallel tree), ``zero1_shardings`` and ``moe_shardings`` (the
JAX ``PartitionSpec``s read as tuples), ``assert_fsdp_sharded``'s counts,
the model run with tensor-parallel weights (``layers.dense``'s megatron
form; FSDP on top of it) and the expert-sharded ``moe_ffn`` forward and gradients against
JAX, and the process group of ``parallel/multihost.py``: a no-op in one
process, and two ``gloo`` processes of which rank 0 is primary.

The JAX side runs on the conftest's 8 virtual CPU devices, the port on a
mesh of ``cpu`` repeated. Tolerances (f32 on the CPU): specs and counts
exact; outputs ``atol=rtol=1e-5``, gradients ``atol=rtol=1e-4``.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.models import mllm as jmllm
from mllm_sparse_retrieval_tpu.models.llama import LlamaConfig as JLlama
from mllm_sparse_retrieval_tpu.models.mllm import MLLMConfig as JMLLMConfig
from mllm_sparse_retrieval_tpu.models.vit import ViTConfig as JViTConfig
from mllm_sparse_retrieval_tpu.parallel import ep as jep
from mllm_sparse_retrieval_tpu.parallel import fsdp as jfsdp
from mllm_sparse_retrieval_tpu.parallel import make_mesh as jmake_mesh
from mllm_sparse_retrieval_tpu.parallel import tp as jtp
from mllm_sparse_retrieval_tpu.train import trainer as jtrainer
from mllm_sparse_retrieval_tpu_torch.models import mllm
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import (
    from_jax_params)
from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
from mllm_sparse_retrieval_tpu_torch.models.mllm import MLLMConfig
from mllm_sparse_retrieval_tpu_torch.models.vit import ViTConfig
from mllm_sparse_retrieval_tpu_torch.parallel import Sharded, ep, fsdp, tp
from mllm_sparse_retrieval_tpu_torch.parallel.mesh import make_mesh
from mllm_sparse_retrieval_tpu_torch.parallel.multihost import (
    initialize_multihost, is_primary_host)
from mllm_sparse_retrieval_tpu_torch.train.trainer import zero1_shardings
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
REPO = Path(__file__).resolve().parent.parent
VIT = dict(image_size=32, patch_size=16, hidden_size=64, num_layers=2,
           num_heads=4, feature_layer=-2)
TEXT = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=256, rope_theta=10000.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _key(entry):
    return getattr(entry, "key", getattr(entry, "idx", entry))


def _jspecs(shardings):
    """``[(path, spec tuple)]`` of a JAX tree of ``NamedSharding``s, in
    JAX's leaf order (dict keys sorted)."""
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    return [(tuple(_key(k) for k in path), tuple(s.spec))
            for path, s in flat]


def _pspecs(tree, path=()):
    """The same of the port's spec-tuple tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _pspecs(tree[k],
                                                         path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _pspecs(v, path + (i,))]
    return [(path, tree)]


@pytest.fixture(scope="module")
def model():
    jarch = JMLLMConfig(vision=JViTConfig(**VIT), text=JLlama(**TEXT),
                        image_token_id=4)
    arch = MLLMConfig(vision=ViTConfig(**VIT), text=LlamaConfig(**TEXT),
                      image_token_id=4)
    jparams = jmllm.init_params(jax.random.PRNGKey(0), jarch, jnp.float32)
    return jparams, jarch, from_jax_params(_np(jparams), "cpu"), arch


def test_spec_trees_match_jax(model):
    jparams, _, params, _ = model
    jmesh = jmake_mesh(data_parallel=4, model_parallel=2)
    mesh = make_mesh(4, 2, devices=["cpu"] * 8)
    assert dict(mesh.shape) == dict(jmesh.shape)
    pairs = [
        (jtp.tp_param_shardings(jparams, jmesh),
         tp.tp_param_shardings(params, mesh)),
        (jfsdp.fsdp_shardings(jparams, jmesh),
         fsdp.fsdp_shardings(params, mesh)),
        (jfsdp.fsdp_shardings(jparams, jmesh, min_size=1024),
         fsdp.fsdp_shardings(params, mesh, min_size=1024)),
        (jtrainer.zero1_shardings(jparams, jmesh),
         zero1_shardings(params, mesh)),
        # FSDP on a tensor-parallel tree: both axes on some leaves
        (jfsdp.fsdp_shardings(jtp.shard_params_tp(jparams, jmesh), jmesh,
                              min_size=1024),
         fsdp.fsdp_shardings(tp.shard_params_tp(params, mesh), mesh,
                             min_size=1024)),
    ]
    for j, p in pairs:
        assert _pspecs(p) == _jspecs(j)
    both = [s for _, s in _pspecs(pairs[-1][1]) if {"data", "model"} <=
            set(s)]
    assert both
    # a dim the axis does not divide stays whole; scalars and odd leaves
    small = {"blocks": [{"q": {"w": np.zeros((7, 9))}}],
             "a": np.zeros((16, 4)), "b": np.zeros((3, 4)), "c": np.zeros(())}
    jsmall = jax.tree_util.tree_map(jnp.asarray, small)
    assert _pspecs(tp.tp_param_shardings(small, mesh)) == \
        _jspecs(jtp.tp_param_shardings(jsmall, jmesh))
    assert _pspecs(zero1_shardings(small, mesh)) == \
        _jspecs(jtrainer.zero1_shardings(jsmall, jmesh))


def test_moe_specs_and_divisibility_match_jax():
    jp = jep.moe_init(jax.random.PRNGKey(3), 16, 24,
                      jep.MoEConfig(num_experts=8))
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    jmesh = jmake_mesh(data_parallel=2, model_parallel=4)
    mesh = make_mesh(2, 4, devices=["cpu"] * 8)
    assert _pspecs(ep.moe_shardings(p, mesh)) == \
        _jspecs(jep.moe_shardings(jp, jmesh))
    sharded = ep.shard_moe_params(p, mesh)
    assert isinstance(sharded["gate"], Sharded)
    assert sharded["router"] is p["router"]
    assert [tuple(x.shape) for x in sharded["gate"].pieces] == \
        [(2, 16, 24)] * 4
    bad = make_mesh(1, 3, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="not divisible"):
        ep.shard_moe_params(p, bad, axis="model")
    with pytest.raises(ValueError, match="not divisible"):
        jep.shard_moe_params(jp, jmake_mesh(
            data_parallel=1, model_parallel=3, devices=jax.devices()[:3]),
            axis="model")


def test_fsdp_counts_and_placement_match_jax(model):
    jparams, _, params, _ = model
    jmesh = jmake_mesh(data_parallel=8, model_parallel=1)
    mesh = make_mesh(8, 1, devices=["cpu"] * 8)
    for min_size in (fsdp.MIN_SHARD_SIZE, 1024):
        placed = fsdp.shard_params_fsdp(params, mesh, min_size)
        jplaced = jfsdp.shard_params_fsdp(jparams, jmesh, min_size)
        n = fsdp.assert_fsdp_sharded(placed, mesh, min_size)
        assert n == jfsdp.assert_fsdp_sharded(jplaced, jmesh, min_size) > 0
        # the caller's tree is untouched and the pieces are new tensors
        for path, spec in _pspecs(fsdp.fsdp_shardings(params, mesh,
                                                      min_size)):
            leaf, orig = placed, params
            for k in path:
                leaf, orig = leaf[k], orig[k]
            if "data" in spec:
                assert isinstance(leaf, Sharded)
                assert torch.equal(leaf.gather("cpu"), orig)
                assert all(t.data_ptr() != orig.data_ptr()
                           for t in leaf.tensors())
            else:
                assert leaf is orig
    # a large leaf left whole is refused
    with pytest.raises(AssertionError, match="data-divisible"):
        fsdp.assert_fsdp_sharded(params, mesh)


def test_tensor_parallel_model_matches_jax(model):
    """``mllm.encode`` with megatron-split weights (the column and row
    forms of ``layers.dense``) against the JAX model under TP, and its
    gradients against the unsplit port model's."""
    jparams, jarch, params, arch = model
    jmesh = jmake_mesh(data_parallel=4, model_parallel=2)
    mesh = make_mesh(4, 2, devices=["cpu"] * 8)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 512, size=(2, 16)).astype(np.int32)
    ids[:, 1:5] = 4
    mask = np.ones((2, 16), np.int32)
    mask[1, 12:] = 0
    px = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    with jmesh:
        jd = jmllm.encode(jtp.shard_params_tp(jparams, jmesh), jarch,
                          jnp.asarray(ids), jnp.asarray(mask),
                          jnp.asarray(px))[1]
    params_tp = tp.shard_params_tp(params, mesh)
    assert isinstance(params_tp["text"]["blocks"][0]["q"]["w"], Sharded)
    assert isinstance(params_tp["vision"]["blocks"][0]["fc2"]["w"], Sharded)
    args = (torch.from_numpy(ids).long(), torch.from_numpy(mask),
            torch.from_numpy(px))
    leaves = [params["text"]["blocks"][0][n]["w"] for n in ("q", "down")]
    pieces = [t for n in ("q", "down")
              for t in params_tp["text"]["blocks"][0][n]["w"].pieces]
    for t in leaves + pieces:
        t.requires_grad_(True)
    d = mllm.encode(params_tp, arch, *args)[1]
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd), **TOL)
    d_one = mllm.encode(params, arch, *args)[1]
    np.testing.assert_allclose(d.detach().numpy(), d_one.detach().numpy(),
                               **TOL)
    # FSDP on the tensor-parallel tree: model-axis pieces split again over
    # the data axis, gathered per use inside the megatron form
    both = fsdp.shard_params_fsdp(params_tp, mesh, min_size=1024)
    q = both["text"]["blocks"][0]["q"]["w"]
    assert q.spec == ("data", "model") and isinstance(q.pieces[0], Sharded)
    with torch.no_grad():
        d_both = mllm.encode(fsdp.local_view(both, "cpu"), arch, *args)[1]
    np.testing.assert_allclose(d_both.numpy(), d_one.detach().numpy(), **TOL)
    probe = torch.from_numpy(rng.normal(size=d.shape).astype(np.float32))
    g_tp = torch.autograd.grad((d * probe).sum(), pieces)
    g_one = torch.autograd.grad((d_one * probe).sum(), leaves)
    for got, want, dim in ((g_tp[:2], g_one[0], 1), (g_tp[2:], g_one[1], 0)):
        np.testing.assert_allclose(torch.cat(got, dim=dim).numpy(),
                                   want.numpy(), **GRAD_TOL)
    for t in leaves:
        t.requires_grad_(False)


def test_expert_sharded_moe_matches_jax():
    """``moe_ffn`` on stacks split over the model axis: output, load-balance
    loss and gradients against JAX's jitted expert-sharded layer."""
    jcfg = jep.MoEConfig(num_experts=8, top_k=2)
    cfg = ep.MoEConfig(num_experts=8, top_k=2)
    jp = jep.moe_init(jax.random.PRNGKey(3), 16, 24, jcfg)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(8, 4, 16)).astype(np.float32)
    jmesh = jmake_mesh(data_parallel=2, model_parallel=4)

    def jloss(p, xs):
        y, aux = jep.moe_ffn(xs, p, jcfg)
        return jnp.mean(y ** 2) + jcfg.aux_loss_coef * aux, (y, aux)

    from jax.sharding import NamedSharding, PartitionSpec as P
    with jmesh:
        (jl, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(
                jep.shard_moe_params(jp, jmesh),
                jax.device_put(jnp.asarray(x),
                               NamedSharding(jmesh, P("data"))))
    mesh = make_mesh(2, 4, devices=["cpu"] * 8)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    ps = ep.shard_moe_params(p, mesh)
    leaves = {"router": ps["router"].requires_grad_(True)}
    for k in ("gate", "up", "down"):
        for t in ps[k].pieces:
            t.requires_grad_(True)
    y, aux = ep.moe_ffn(torch.from_numpy(x), ps, cfg)
    loss = (y ** 2).mean() + cfg.aux_loss_coef * aux
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    grads = torch.autograd.grad(
        loss, [leaves["router"]] + [t for k in ("gate", "up", "down")
                                    for t in ps[k].pieces])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg["router"]),
                               **GRAD_TOL)
    for i, k in enumerate(("gate", "up", "down")):
        got = torch.cat(grads[1 + 4 * i:5 + 4 * i]).numpy()
        np.testing.assert_allclose(got, np.asarray(jg[k]), **GRAD_TOL)


def test_multihost_is_a_no_op_in_one_process(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_multihost() is False
    assert initialize_multihost(num_processes=1, device="cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "2")        # no address: nothing to do
    assert initialize_multihost(device="cpu") is False
    assert is_primary_host()
    assert not torch.distributed.is_initialized()


_RANK = """
import sys
from mllm_sparse_retrieval_tpu_torch.parallel.multihost import (
    initialize_multihost, is_primary_host)
import torch.distributed as dist
ok = initialize_multihost(device="cpu")
t = __import__("torch").ones(1) * (dist.get_rank() + 1)
dist.all_reduce(t)
print(ok, is_primary_host(), int(t.item()))
dist.destroy_process_group()
"""


def test_multihost_two_gloo_processes():
    """Two processes from the launcher's environment join one ``gloo``
    group; rank 0 is primary, and an all-reduce sees both."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                   PYTHONPATH=str(REPO) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(out.split())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert outs == [["True", "True", "3"], ["True", "False", "3"]]

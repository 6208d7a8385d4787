"""Scaling report: per-device memory and a census of cross-shard transfers
across mesh sizes.

Two things decide whether a sharded program scales, and both can be read
without several cards:

1. **Per-device bytes** of the parameters and the optimizer state under
   each strategy (replicated, ZeRO-1, FSDP, tensor parallelism, pipeline
   stages), exact from the port's sharding specs (``fsdp_shardings``,
   ``tp_param_shardings``, ``zero1_shardings``,
   ``pp.stacked_tp_shardings``) on trees of shapes only (fake tensors: no
   memory is allocated).
2. **The transfers one grad step makes** under the port's FSDP, TP and
   dp x pp x tp forms, counted by counters this tool puts around the
   port's own helpers for one step on a mesh of ``--devices`` devices
   (the device repeated: one card, or the CPU):

   - ``all-gather``: a ``Sharded`` leaf gathered whole (FSDP's per-use
     gather, a tensor-parallel column split's output columns), and in the
     backward pass a row split's input-gradient slices;
   - ``reduce-scatter``: a gathered leaf's gradient split back onto its
     pieces in the backward pass;
   - ``all-reduce``: a row split's partial products summed, and in the
     backward pass a column split's partial input gradients;
   - ``collective-permute``: a pipeline stage handing a microbatch to the
     next stage, forward and backward.

   The port has no compiler: these are calls counted as they run (every
   per-shard, per-layer and per-microbatch transfer), not the ops of a
   compiled program, so they are not comparable to counts read from XLA's
   HLO. The sum of a replicated leaf's gradient over data shards happens
   inside autograd's accumulation and is not counted.

    python -m mllm_sparse_retrieval_tpu_torch.tools.scaling_report \\
        [--devices 8] [--device cuda]

``main`` returns the byte rows (name -> bytes) and the census (strategy ->
counts).
"""

import argparse
import contextlib
from collections import Counter

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.tools.common import (
    checked_device, hardware, sync)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
               "collective-permute", "all-to-all")


def report_config():
    """A mid-size decoder, so that the byte numbers mean something
    (~0.5 GB f32)."""
    from mllm_sparse_retrieval_tpu_torch.models import llama

    return llama.LlamaConfig(vocab_size=32000, hidden_size=1024,
                             num_layers=8, num_heads=16, num_kv_heads=4,
                             intermediate_size=4096)


def _nbytes(leaf) -> int:
    return int(np.prod(tuple(leaf.shape))) * leaf.element_size()


def _leaves(tree):
    """A tree's leaves in order (dicts and lists are nodes; a spec tuple
    is a leaf)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def bytes_per_device(tree, specs, mesh) -> int:
    """Exact per-device bytes of ``tree`` placed by ``specs`` (spec tuples
    in the tree's layout) on ``mesh``: each leaf's bytes over the product
    of its split axes' sizes, rounded up."""
    total = 0
    for leaf, spec in zip(_leaves(tree), _leaves(specs)):
        n_shards = 1
        for axis in spec:
            if axis is None:
                continue
            for name in (axis if isinstance(axis, tuple) else (axis,)):
                n_shards *= mesh.shape[name]
        total += int(np.ceil(_nbytes(leaf) / n_shards))
    return total


def shape_trees(cfg):
    """``(params, adam state, stacked blocks)`` of ``cfg`` in f32 as fake
    tensors (shapes and dtypes, no storage). The Adam state holds the
    step count and the two moments, as the JAX package's optimizer
    state does."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from mllm_sparse_retrieval_tpu_torch.models import llama
    from mllm_sparse_retrieval_tpu_torch.parallel import pp
    from mllm_sparse_retrieval_tpu_torch.parallel.mesh import tree_map

    with FakeTensorMode():
        params = llama.init_params(cfg, torch.Generator(), device="cpu",
                                   dtype=torch.float32)
        like = (lambda _, x: torch.empty_like(x))
        opt = {"count": torch.zeros((), dtype=torch.int32),
               "mu": tree_map(like, params), "nu": tree_map(like, params)}
        stacked = pp.stack_block_params(params["blocks"])
    return params, opt, stacked


def byte_rows(params, opt, stacked, n, devices):
    """``[(name, bytes per device)]``, the JAX tool's rows in its order."""
    from mllm_sparse_retrieval_tpu_torch.parallel import pp
    from mllm_sparse_retrieval_tpu_torch.parallel.fsdp import fsdp_shardings
    from mllm_sparse_retrieval_tpu_torch.parallel.mesh import (
        make_mesh, tree_map)
    from mllm_sparse_retrieval_tpu_torch.parallel.tp import tp_param_shardings
    from mllm_sparse_retrieval_tpu_torch.train.trainer import zero1_shardings

    mesh_dp = make_mesh(n, 1, devices=devices)
    mesh_tp = make_mesh(n // 2, 2, devices=devices)
    whole = (lambda _, x: ())
    rows = [
        ("replicated (reference DDP)", params, tree_map(whole, params),
         mesh_dp),
        ("FSDP / ZeRO-3 params", params, fsdp_shardings(params, mesh_dp),
         mesh_dp),
        ("megatron TP (model=2) params", params,
         tp_param_shardings(params, mesh_tp), mesh_tp),
        ("adam state replicated", opt, tree_map(whole, opt), mesh_dp),
        ("adam state ZeRO-1", opt, zero1_shardings(opt, mesh_dp), mesh_dp),
    ]
    if n % 4 == 0:
        mesh3 = pp.make_pp3_mesh(n // 4, 2, 2, devices=devices)
        rows.append(("pp x tp stacked blocks (pipe=2, model=2)", stacked,
                     pp.stacked_tp_shardings(stacked, mesh3), mesh3))
    return [(name, bytes_per_device(tree, sh, mesh))
            for name, tree, sh, mesh in rows]


class _Marked(torch.autograd.Function):
    """Identity whose backward pass counts one transfer of ``kind``."""

    @staticmethod
    def forward(ctx, x, counts, kind):
        ctx.counts, ctx.kind = counts, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.counts[ctx.kind] += 1
        return g, None, None


def _mark(x, counts, kind):
    if torch.is_grad_enabled() and x.requires_grad:
        return _Marked.apply(x, counts, kind)
    return x


@contextlib.contextmanager
def counting():
    """Count the transfers the port's helpers make (see the module
    docstring) while the block runs; yields the ``Counter``."""
    from mllm_sparse_retrieval_tpu_torch.models import layers
    from mllm_sparse_retrieval_tpu_torch.parallel import pp
    from mllm_sparse_retrieval_tpu_torch.parallel.mesh import (
        MODEL_AXIS, Sharded)

    counts = Counter({k: 0 for k in COLLECTIVES})
    real_gather, real_dense = Sharded.gather, layers.dense
    real_copy = pp._stage_copy

    def gather(self, device):
        out = real_gather(self, device)
        if len(self.pieces) * self.processes > 1:
            counts["all-gather"] += 1
            out = _mark(out, counts, "reduce-scatter")
        return out

    def dense(x, p, *a, **k):
        w = p["w"]
        if isinstance(w, Sharded) and w.axis == MODEL_AXIS \
                and len(w.pieces) > 1:
            column = w.dim == 1
            counts["all-gather" if column else "all-reduce"] += 1
            x = _mark(x, counts, "all-reduce" if column else "all-gather")
        return real_dense(x, p, *a, **k)

    def stage_copy(x, device):
        counts["collective-permute"] += 1
        return _mark(real_copy(x, device), counts, "collective-permute")

    Sharded.gather, layers.dense, pp._stage_copy = gather, dense, stage_copy
    try:
        yield counts
    finally:
        Sharded.gather, layers.dense = real_gather, real_dense
        pp._stage_copy = real_copy


def _grad_leaves(tree):
    from mllm_sparse_retrieval_tpu_torch.parallel.mesh import Sharded

    out = []
    for leaf in _leaves(tree):
        ts = leaf.tensors() if isinstance(leaf, Sharded) else [leaf]
        for t in ts:
            t.requires_grad_(True)
            out.append(t)
    return out


def census(cfg, n, devices, batch=None, seq=32, seed=0):
    """Transfer counts of one grad step (``sum(y * y)`` of the decoder's
    hidden states) under FSDP on an ``n``-shard data axis, TP on
    ``(n // 2, 2)`` and, when 4 divides ``n``, dp x pp x tp on
    ``(n // 4, 2, 2)`` with 2 microbatches: ``{strategy: counts}``."""
    from mllm_sparse_retrieval_tpu_torch.models import llama
    from mllm_sparse_retrieval_tpu_torch.parallel import pp
    from mllm_sparse_retrieval_tpu_torch.parallel.fsdp import (
        local_view, shard_params_fsdp)
    from mllm_sparse_retrieval_tpu_torch.parallel.mesh import make_mesh
    from mllm_sparse_retrieval_tpu_torch.parallel.tp import shard_params_tp

    lead = torch.device(devices[0])
    b = 2 * n if batch is None else batch
    gen = torch.Generator(device=lead.type).manual_seed(seed)
    params = llama.init_params(cfg, gen, device=lead, dtype=torch.float32)
    ids = torch.zeros((b, seq), dtype=torch.long, device=lead)
    mask = torch.ones((b, seq), dtype=torch.long, device=lead)
    out = {}

    def step(tree, mesh, view):
        rows = b // mesh.shape["data"]
        loss = None
        for i, dev in enumerate(mesh.shard_devices):
            p = view(tree, dev)
            sl = slice(i * rows, (i + 1) * rows)
            emb = llama.embed_tokens(p, ids[sl].to(dev))
            y = llama.apply(p, emb, mask[sl].to(dev), cfg, allow_flash=False)
            part = (y * y).sum().to(lead)
            loss = part if loss is None else loss + part
        loss.backward()

    mesh_dp = make_mesh(n, 1, devices=devices)
    sharded = shard_params_fsdp(params, mesh_dp)
    _grad_leaves(sharded)
    with counting() as counts:
        step(sharded, mesh_dp, local_view)
    out["FSDP grad step"] = dict(counts)

    mesh_tp = make_mesh(n // 2, 2, devices=devices)
    split = shard_params_tp(params, mesh_tp)
    _grad_leaves(split)
    with counting() as counts:
        step(split, mesh_tp, lambda tree, dev: tree)
    out["TP (model=2) grad step"] = dict(counts)
    del sharded, split

    if n % 4 == 0:
        mesh3 = pp.make_pp3_mesh(n // 4, 2, 2, devices=devices)
        stacked = pp.stack_block_params(params["blocks"])
        stacked = {k: {kk: vv.detach().clone().requires_grad_(True)
                       for kk, vv in v.items()} for k, v in stacked.items()}
        rest = {"final_norm": {"scale": torch.zeros(
            cfg.hidden_size, device=lead)}}
        emb = torch.zeros((b, seq, cfg.hidden_size), device=lead)
        with counting() as counts:
            y = pp.apply_pipelined_gspmd(rest, emb, mask, cfg, mesh3, 2,
                                         stacked=stacked)
            (y * y).sum().backward()
        out["dp x pp x tp pipeline step"] = dict(counts)
    return out


def _fmt(b):
    return f"{b / 1e6:8.2f} MB"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="the torch device the mesh repeats; cuda needs a "
                         "card")
    args = ap.parse_args(argv)
    device = checked_device(args.device)
    n = args.devices
    devices = [device] * n

    cfg = report_config()
    params, opt, stacked = shape_trees(cfg)
    p_total = sum(_nbytes(x) for x in _leaves(params))
    o_total = sum(_nbytes(x) for x in _leaves(opt))
    print(f"decoder: {p_total / 1e6:.0f} MB params, "
          f"{o_total / 1e6:.0f} MB adam state, {n} devices\n")

    print("per-device bytes by strategy (exact, from sharding specs):")
    rows = byte_rows(params, opt, stacked, n, devices)
    for name, nbytes in rows:
        print(f"  {name:42s} {_fmt(nbytes)}")

    print(f"\ntransfers of one grad step (counted as they run, on {n} x "
          f"{device}; {hardware(device)}):")
    counts = census(cfg, n, devices)
    sync(device)
    labels = {"FSDP grad step": "FSDP grad step:             ",
              "TP (model=2) grad step": "TP (model=2) grad step:     ",
              "dp x pp x tp pipeline step": "dp x pp x tp pipeline step: "}
    for name, c in counts.items():
        print(f"  {labels[name]} {c}")
    return {"bytes": dict(rows), "census": counts}


if __name__ == "__main__":
    main()

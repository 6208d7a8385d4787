"""Pipeline parallelism over stacked decoder blocks (the JAX package's
``parallel/pp.py``): the GPipe schedule.

The decoder's blocks are stacked along a leading layer axis and cut into
``n_stages`` contiguous stages over the mesh's ``pipe`` axis: stage ``s``
holds layers ``[s * L / S, (s + 1) * L / S)`` on pipe device ``s`` (of each
data row). Microbatches enter stage 0 one a tick; at tick ``t`` stage ``s``
runs microbatch ``t - s`` and hands its activation to stage ``s + 1`` with
``.to(next device)``, ``M + S - 1`` ticks in all (the GPipe bubble
``(S - 1) / (M + S - 1)``). The JAX program also computes the bubble's
garbage lanes, whose outputs never reach the last stage; one process
simply skips them. Per-microbatch constants (attention masks, per-sample
RoPE tables) are indexed by the microbatch a stage holds, so each stage
applies the mask of its own activation. Differentiable end to end: the
stage slices are read from the caller's stacked leaves through
``.to(device)``, so gradients land there.

``apply_pipelined_gspmd`` is the JAX package's dp x pp x tp form: the same
schedule with each stage's column / row weights split over the ``model``
axis of its (data, pipe) position (``parallel/tp.py``'s megatron layout,
``layers.dense``), and optionally recomputed per stage (``remat``). As in
the JAX package no flash kernel runs inside the schedule: training
microbatches are short, and the masked attention is the tool there.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from mllm_sparse_retrieval_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, Sharded, grid, tree_at, tree_map)
from mllm_sparse_retrieval_tpu_torch.parallel.tp import (
    _COL_SHARDED, _ROW_SHARDED)

PIPE_AXIS = "pipe"


def _all_cuda(devices):
    if devices is not None:
        return list(devices)
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device; pass devices=")
    return [torch.device("cuda", i) for i in range(n)]


def make_pp_mesh(pipeline_parallel: int, data_parallel: int = -1,
                 devices: Optional[Sequence] = None) -> Mesh:
    """A ``(data, pipe)`` mesh; ``data_parallel=-1`` takes the rest of the
    devices (every CUDA device when ``devices`` is None)."""
    devices = _all_cuda(devices)
    n = len(devices)
    if pipeline_parallel <= 0:
        raise ValueError("pipeline_parallel must be >= 1")
    if data_parallel == -1:
        if n % pipeline_parallel != 0:
            raise ValueError(f"{n} devices not divisible by "
                             f"pipeline_parallel={pipeline_parallel}")
        data_parallel = n // pipeline_parallel
    if data_parallel * pipeline_parallel != n:
        raise ValueError(
            f"data_parallel*pipeline_parallel = "
            f"{data_parallel * pipeline_parallel} != {n} devices")
    return Mesh(grid(devices, (data_parallel, pipeline_parallel)),
                (DATA_AXIS, PIPE_AXIS))


def make_pp3_mesh(data_parallel: int, pipeline_parallel: int,
                  model_parallel: int,
                  devices: Optional[Sequence] = None) -> Mesh:
    """A ``(data, pipe, model)`` mesh for dp x pp x tp."""
    devices = _all_cuda(devices)
    n = data_parallel * pipeline_parallel * model_parallel
    if n != len(devices):
        raise ValueError(f"dp*pp*tp = {n} != {len(devices)} devices")
    return Mesh(grid(devices, (data_parallel, pipeline_parallel,
                               model_parallel)),
                (DATA_AXIS, PIPE_AXIS, MODEL_AXIS))


def _stack(xs):
    if isinstance(xs[0], dict):
        return {k: _stack([x[k] for x in xs]) for k in xs[0]}
    if isinstance(xs[0], (list, tuple)):
        return [_stack([x[i] for x in xs]) for i in range(len(xs[0]))]
    return torch.stack(xs)


def stack_block_params(blocks: Sequence[Dict]) -> Dict:
    """A homogeneous per-layer tree list stacked into ``[L, ...]`` leaves."""
    return _stack(list(blocks))


def unstack_block_params(stacked: Dict, n_layers: int) -> list:
    """Inverse of ``stack_block_params``."""
    return [tree_map(lambda _, x, i=i: x[i], stacked)
            for i in range(n_layers)]


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def _stage_copy(x: torch.Tensor, device) -> torch.Tensor:
    """A microbatch's activations handed to the next stage's device: the
    schedule's one transfer between stages (the JAX package's
    collective-permute)."""
    return x.to(device)


def _gpipe(x_mb: torch.Tensor, consts: Any, batched: Any, n_stages: int,
           n_data: int, stage_device: Callable[[int, int], torch.device],
           stage_layers: Callable[[int, int], List[Any]],
           block_fn: Callable, remat: bool = False) -> torch.Tensor:
    """The GPipe schedule: ``x_mb [M, mb, ...]`` through ``n_stages``
    stages, the microbatch rows split over ``n_data`` data shards;
    ``stage_layers(i, s)`` gives stage ``s``'s per-layer trees on
    ``stage_device(i, s)``. Returns ``[M, mb, ...]`` on ``x_mb``'s
    device."""
    n_micro, mb = x_mb.shape[0], x_mb.shape[1]
    per = mb // n_data
    home = x_mb.device
    out = [[None] * n_data for _ in range(n_micro)]
    for i in range(n_data):
        rows = slice(i * per, (i + 1) * per)
        layers = [stage_layers(i, s) for s in range(n_stages)]

        def stage(x, s, m, layers=layers, rows=rows, i=i):
            dev = stage_device(i, s)
            c = tree_map(lambda path, a: (
                a[m, rows] if tree_at(batched, path) else a[m]).to(dev),
                consts)
            for blk in layers[s]:
                x = block_fn(x, blk, c)
            return x

        held = {}
        for tick in range(n_micro + n_stages - 1):
            for s in range(n_stages):
                m = tick - s
                if not 0 <= m < n_micro:
                    continue            # a bubble lane
                dev = stage_device(i, s)
                x = x_mb[m, rows].to(dev) if s == 0 \
                    else _stage_copy(held[m], dev)
                held[m] = checkpoint(stage, x, s, m, use_reentrant=False) \
                    if remat else stage(x, s, m)
        for m in range(n_micro):
            out[m][i] = held[m].to(home)
    return torch.stack([torch.cat(row, dim=0) for row in out])


def pipeline_apply(stacked_blocks: Any, x_mb: torch.Tensor, mb_consts: Any,
                   block_fn: Callable, mesh: Mesh, *,
                   consts_batched: Any = None,
                   check_divisible: bool = True) -> torch.Tensor:
    """Run the GPipe schedule; returns activations shaped like ``x_mb``.

    ``stacked_blocks``: block params stacked ``[L, ...]`` (layer-major).
    ``mb_consts``: per-microbatch constants, every leaf's axis 0 the
    microbatch axis ``M``; ``consts_batched`` (a tree of bools, by default
    "axis 1 is the microbatch's rows") says which split over the data axis
    with their activations. ``block_fn(x, blk, consts_m)`` applies one
    block (``blk``'s leaves with the layer axis stripped)."""
    n_stages = mesh.shape[PIPE_AXIS]
    n_layers = _first_leaf(stacked_blocks).shape[0]
    if check_divisible and n_layers % n_stages != 0:
        raise ValueError(f"{n_layers} layers not divisible by "
                         f"{n_stages} pipeline stages")
    lp = n_layers // n_stages
    if consts_batched is None:
        consts_batched = tree_map(
            lambda _, c: c.dim() >= 2 and c.shape[1] == x_mb.shape[1],
            mb_consts)
    n_data = mesh.shape[DATA_AXIS]
    nd = n_data if n_data > 1 and x_mb.shape[1] % n_data == 0 else 1

    def device(i, s):
        return mesh.devices[i, s] if mesh.devices.ndim == 2 else \
            mesh.devices[i, s, 0]

    def layers(i, s):
        dev = device(i, s)
        return [tree_map(lambda _, a, l=l: a[s * lp + l].to(dev),
                         stacked_blocks) for l in range(lp)]

    return _gpipe(x_mb, mb_consts, consts_batched, n_stages, nd, device,
                  layers, block_fn)


def stacked_tp_shardings(stacked: Dict, mesh: Mesh):
    """Spec tuples of STACKED block leaves ``[L, ...]``: the layer axis
    over ``pipe`` when it divides, the megatron column / row layout over
    ``model`` (``parallel/tp.py``'s name sets)."""
    n_pipe = mesh.shape.get(PIPE_AXIS, 1)
    n_model = mesh.shape.get(MODEL_AXIS, 1)

    def make(path, leaf):
        names = [str(p) for p in path]
        spec = [PIPE_AXIS if leaf.shape[0] % n_pipe == 0 else None]
        if leaf.dim() == 3 and names and names[-1] == "w":
            proj = names[-2] if len(names) >= 2 else ""
            if proj in _COL_SHARDED and leaf.shape[2] % n_model == 0:
                spec += [None, MODEL_AXIS]
            elif proj in _ROW_SHARDED and leaf.shape[1] % n_model == 0:
                spec += [MODEL_AXIS, None]
        return tuple(spec)

    return tree_map(make, stacked)


def _micro_consts(cfg, attention_mask, position_ids, t, n_micro, mb,
                  device):
    from mllm_sparse_retrieval_tpu_torch.models import layers as L
    from mllm_sparse_retrieval_tpu_torch.models import llama

    cos, sin = llama.rope_tables(cfg, t, position_ids, device=device)
    mask = L.causal_padding_mask(attention_mask)
    consts = {"mask": mask.reshape((n_micro, mb) + mask.shape[1:])}
    per_sample = cos.dim() == 3
    if per_sample:
        # per-sample tables ([B, T, hd/2]: explicit or M-RoPE positions)
        # ride with their microbatch
        consts["cos"] = cos.reshape((n_micro, mb) + cos.shape[1:])
        consts["sin"] = sin.reshape((n_micro, mb) + sin.shape[1:])
    else:
        consts["cos"] = cos.expand((n_micro,) + cos.shape)
        consts["sin"] = sin.expand((n_micro,) + sin.shape)
    return consts, {"mask": True, "cos": per_sample, "sin": per_sample}


def _refuse_moe(cfg):
    if getattr(cfg, "moe", None) is not None:
        raise ValueError("pipeline parallelism supports dense-FFN decoders "
                         "only; MoE blocks return (x, aux) which the "
                         "stacked-stage schedule does not carry — compose "
                         "parallel/ep.py with dp x tp instead")


def apply_pipelined_gspmd(
    params: Dict,
    inputs_embeds: torch.Tensor,     # [B, T, H]
    attention_mask: torch.Tensor,    # [B, T]
    cfg,                             # models.llama.LlamaConfig
    mesh: Mesh,
    n_microbatches: int,
    stacked: Optional[Dict] = None,
    position_ids: Optional[torch.Tensor] = None,
    remat: bool = False,
) -> torch.Tensor:
    """The dp x pp x tp decoder on a ``(data, pipe, model)`` mesh
    (``make_pp3_mesh``; a ``(data, pipe)`` mesh has no model split):
    ``stacked`` (default: ``params["blocks"]`` stacked) is read stage by
    stage, each stage's column / row weights split over the model-axis
    devices of its (data, pipe) position, the others whole there.
    ``remat=True`` recomputes each stage's microbatch in the backward
    pass. Returns the final-norm hidden states ``[B, T, H]``."""
    from mllm_sparse_retrieval_tpu_torch.models import layers as L
    from mllm_sparse_retrieval_tpu_torch.models import llama

    _refuse_moe(cfg)
    b, t, h = inputs_embeds.shape
    if b % n_microbatches != 0:
        raise ValueError(f"batch {b} not divisible by "
                         f"n_microbatches={n_microbatches}")
    n_stages = mesh.shape[PIPE_AXIS]
    mb = b // n_microbatches
    if stacked is None:
        stacked = stack_block_params(params["blocks"])
    n_layers = _first_leaf(stacked).shape[0]
    if n_layers % n_stages != 0:
        raise ValueError(f"{n_layers} layers not divisible by "
                         f"{n_stages} pipeline stages")
    lp = n_layers // n_stages
    specs = stacked_tp_shardings(stacked, mesh)
    consts, batched = _micro_consts(cfg, attention_mask, position_ids, t,
                                    n_microbatches, mb, inputs_embeds.device)
    n_data = mesh.shape[DATA_AXIS]
    nd = n_data if n_data > 1 and mb % n_data == 0 else 1
    has_model = MODEL_AXIS in mesh.shape

    def device(i, s):
        return mesh.devices[i, s, 0] if has_model else mesh.devices[i, s]

    def layers(i, s):
        model_devs = list(mesh.devices[i, s]) if has_model else [device(i, s)]

        def leaf(path, a, l):
            x = a[s * lp + l]
            spec = tree_at(specs, path)
            if MODEL_AXIS not in spec or len(model_devs) == 1:
                return x.to(device(i, s))
            d = spec.index(MODEL_AXIS) - 1        # the layer axis dropped
            step = x.shape[d] // len(model_devs)
            return Sharded([x.narrow(d, j * step, step).to(dv)
                            for j, dv in enumerate(model_devs)],
                           model_devs, d, spec[1:])

        return [tree_map(lambda p, a, l=l: leaf(p, a, l), stacked)
                for l in range(lp)]

    def block_fn(x, blk, c):
        return llama._block(x, blk, cfg, c["mask"], c["cos"], c["sin"])

    y = _gpipe(inputs_embeds.reshape(n_microbatches, mb, t, h), consts,
               batched, n_stages, nd, device, layers, block_fn, remat=remat)
    return L.rmsnorm(y.reshape(b, t, h), params["final_norm"], cfg.rms_eps)


def apply_pipelined(
    params: Dict,
    inputs_embeds: torch.Tensor,     # [B, T, H]
    attention_mask: torch.Tensor,    # [B, T]
    cfg,                             # models.llama.LlamaConfig
    mesh: Mesh,
    n_microbatches: int,
    lora: Optional[Dict] = None,
    stacked: Optional[Dict] = None,
    lora_stacked: Optional[Dict] = None,
    position_ids: Optional[torch.Tensor] = None,  # [B, T] or [3, B, T]
) -> torch.Tensor:
    """``models.llama.apply`` through the GPipe schedule on a ``(data,
    pipe)`` mesh: ``B`` divides into ``n_microbatches`` equal microbatches
    (their rows split over the data axis when it divides them). Pass
    ``stacked`` / ``lora_stacked`` (``stack_block_params``) to
    differentiate with respect to the stacked leaves; otherwise the
    per-layer lists in ``params["blocks"]`` / ``lora["blocks"]`` are
    stacked here. LoRA adapters must cover every block (homogeneous
    stages), as in the JAX package. ``position_ids`` follow
    ``llama.apply``'s contract, M-RoPE included."""
    from mllm_sparse_retrieval_tpu_torch.models import layers as L
    from mllm_sparse_retrieval_tpu_torch.models import llama

    _refuse_moe(cfg)
    b, t, h = inputs_embeds.shape
    if b % n_microbatches != 0:
        raise ValueError(f"batch {b} not divisible by "
                         f"n_microbatches={n_microbatches}")
    mb = b // n_microbatches
    if stacked is None:
        stacked = stack_block_params(params["blocks"])
    if lora_stacked is None and lora is not None and lora.get("blocks"):
        blist = lora["blocks"]
        if all(bl for bl in blist):
            lora_stacked = stack_block_params(blist)
        else:
            # partial-layer adapters cannot stack into a homogeneous
            # [L, ...] tree; dropping them would train the bare base
            raise ValueError(
                "apply_pipelined needs LoRA adapters on EVERY block "
                "(homogeneous stages); got adapters on "
                f"{sum(bool(bl) for bl in blist)}/{len(blist)} blocks")
    consts, batched = _micro_consts(cfg, attention_mask, position_ids, t,
                                    n_microbatches, mb, inputs_embeds.device)
    if lora_stacked is not None:
        blocks_in = {"p": stacked, "lora": lora_stacked}

        def block_fn(x, blk, c):
            return llama._block(x, blk["p"], cfg, c["mask"], c["cos"],
                                c["sin"], blk["lora"])
    else:
        blocks_in = stacked

        def block_fn(x, blk, c):
            return llama._block(x, blk, cfg, c["mask"], c["cos"], c["sin"])

    y = pipeline_apply(blocks_in,
                       inputs_embeds.reshape(n_microbatches, mb, t, h),
                       consts, block_fn, mesh, consts_batched=batched)
    return L.rmsnorm(y.reshape(b, t, h), params["final_norm"], cfg.rms_eps)

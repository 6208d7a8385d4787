"""FSDP parameter sharding over the data axis (the JAX package's
``parallel/fsdp.py``; DeepSpeed ZeRO-3's idea).

Every large leaf is split on its largest dim that the data axis divides,
piece ``i`` on data shard ``i``'s device (a ``parallel.mesh.Sharded``);
smaller leaves stay whole on the mesh's lead device. A weight is gathered
where it is used: ``layers.dense`` gathers a split ``w`` onto its input's
device per call (a recompute under remat gathers again), and the trainer
gathers the other split leaves (embeddings, the LM head, patch embeddings)
once per step and shard; gradients land on the pieces through the gather.
The specs are those of the JAX package, ``PartitionSpec`` read as a tuple.
A leaf already split over the model axis (tensor parallelism) keeps that
split and gains the data axis on another dim when one divides. Over a data
axis that spans processes (``Mesh.processes`` > 1) the split counts the
global data axis and each process keeps its own pieces; a gather is then a
collective (``multihost.all_gather_rows``) whose backward reduce-scatters
the gradient onto the pieces.
"""

from __future__ import annotations

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, Sharded, leaf_spec, spec_axes, split,
    tree_at, tree_map)

# leaves smaller than this stay whole (splitting tiny tensors costs more in
# copies than it saves in memory)
MIN_SHARD_SIZE = 2 ** 14


def _size(x) -> int:
    shape = tuple(getattr(x, "shape", ()))
    return int(np.prod(shape)) if shape else 0


def fsdp_shardings(tree, mesh: Mesh, min_size: int = MIN_SHARD_SIZE):
    """Per-leaf spec tuples: the largest data-divisible dim over
    ``"data"``, the rest unsplit (``()`` for a leaf left whole). A leaf's
    existing split over another axis is kept."""
    n = mesh.data_size

    def leaf(_, x):
        shape = tuple(getattr(x, "shape", ()))
        existing = list(leaf_spec(x))
        whole = tuple(existing) if any(e is not None for e in existing) \
            else ()
        if not shape or _size(x) < min_size or n <= 1 \
                or DATA_AXIS in spec_axes(existing):
            return whole
        for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
            if existing[d] is None and shape[d] % n == 0:
                spec = list(existing)
                spec[d] = DATA_AXIS
                return tuple(spec)
        return whole

    return tree_map(leaf, tree)


def shard_params_fsdp(params, mesh: Mesh, min_size: int = MIN_SHARD_SIZE):
    """A new tree with ``fsdp_shardings``' placement: split leaves are
    ``Sharded`` over the data axis (their pieces new tensors), whole ones
    on ``mesh.lead``. The caller's tree is not changed."""
    specs = fsdp_shardings(params, mesh, min_size)

    def place(path, x):
        spec = tree_at(specs, path)
        if DATA_AXIS not in spec_axes(spec) or DATA_AXIS in spec_axes(
                leaf_spec(x)):
            return x.to(mesh.lead) if hasattr(x, "to") and not isinstance(
                x, Sharded) else x
        d = spec.index(DATA_AXIS)
        if isinstance(x, Sharded):      # tensor-parallel: split each piece
            return Sharded(
                [split(p, d, mesh.axis_devices(DATA_AXIS, {MODEL_AXIS: j}),
                       spec, mesh) for j, p in enumerate(x.pieces)],
                x.devices, x.dim, spec)
        return split(x, d, mesh.shard_devices, spec, mesh)

    return tree_map(place, params)


def local_view(tree, device):
    """``tree`` as a data shard on ``device`` reads it: tensors moved there
    (differentiably; the same tensor on its own device), the ``w`` of a
    dense layer left split (``layers.dense`` gathers it per use, or runs a
    model-axis split in the megatron form) and every other split leaf
    gathered there. The LM head's ``w`` is read whole by
    ``llama.lm_head_weight``, so it is gathered too."""
    from mllm_sparse_retrieval_tpu_torch.models.quantization import (
        QuantizedWeight)

    def leaf(path, x):
        if isinstance(x, Sharded):
            if path and path[-1] == "w" and "lm_head" not in path:
                return x
            return x.gather(device)
        if isinstance(x, (torch.Tensor, QuantizedWeight)):
            return x.to(device)
        return x

    return tree_map(leaf, tree)


def assert_fsdp_sharded(params, mesh: Mesh,
                        min_size: int = MIN_SHARD_SIZE) -> int:
    """Check that every large leaf ``fsdp_shardings`` would split is split
    over the data axis; returns how many are. Leaves whose only divisible
    dims are taken by another axis are skipped, as in the JAX package."""
    n = mesh.data_size
    count = 0

    def check(path, x):
        nonlocal count
        if _size(x) < min_size or n <= 1:
            return
        spec = leaf_spec(x)
        if DATA_AXIS in spec_axes(spec):
            count += 1
            return
        shardable = any(s % n == 0 and spec[d] is None
                        for d, s in enumerate(x.shape))
        assert not shardable, (
            f"leaf {path} {tuple(x.shape)} has a free data-divisible dim "
            f"but no data-axis split: {spec}")

    tree_map(check, params)
    return count

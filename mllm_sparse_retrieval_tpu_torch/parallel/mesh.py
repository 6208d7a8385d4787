"""Device meshes for one process (the JAX package's ``parallel/mesh.py``).

A ``Mesh`` is a ``[data, model]`` array of torch devices. One Python
process drives every shard: a "sharded" tensor is a list of per-shard
tensors, shard ``i`` of the data axis on ``mesh.devices[i, 0]``, each its
own contiguous tensor. The JAX package's ``shard_map`` becomes a loop over
the shards that runs the local function on each shard's device (CUDA
launches are asynchronous, so shards on distinct cards overlap), and its
``all_gather`` becomes copies of each shard's small result to the mesh's
``lead`` device, where the merge runs.

A device may appear more than once: ``make_mesh(4, devices=["cuda:0"] *
4)`` is four shards on one card, each with its own tensors and its own
kernel launches. That runs the sharded code path on a machine with one
card (the counterpart of the JAX tests' virtual CPU devices); it does not
exercise copies between distinct cards. ``replicated`` places one copy per
distinct device, so repeated shards share it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


def canonical_device(device) -> torch.device:
    """One spelling per device: ``cpu:0`` is ``cpu``, and a CUDA device
    without an index is the current one."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.device("cpu")
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """A ``[data, model]`` grid of devices.

    ``shape`` maps ``{DATA_AXIS: d, MODEL_AXIS: m}`` as a JAX mesh's does.
    Shard ``i`` of a data-sharded tensor lives on ``shard_devices[i]``
    (``devices[i, 0]``); merged results land on ``lead``
    (``devices[0, 0]``). Equality is identity, as caches keyed on a mesh
    expect."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"mesh devices must be [data, model], got "
                             f"shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self):
        return {DATA_AXIS: self.devices.shape[0],
                MODEL_AXIS: self.devices.shape[1]}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        return self.devices[0, 0]

    @property
    def shard_devices(self) -> List[torch.device]:
        return [self.devices[i, 0] for i in range(self.devices.shape[0])]

    def row(self, i: int) -> "Mesh":
        """The ``1 x model`` mesh of data shard ``i`` (its model-axis
        devices), cached so a row is one object across calls."""
        rows = self.__dict__.setdefault("_rows", {})
        if i not in rows:
            rows[i] = Mesh(self.devices[i:i + 1])
        return rows[i]

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(data_parallel: int = -1, model_parallel: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a 2-D ``(data, model)`` mesh.

    ``devices=None`` takes every CUDA device (one card gives a 1x1 mesh,
    on which every sharded program still runs); ``data_parallel=-1``
    takes all devices not consumed by ``model_parallel``. ``devices`` may
    repeat a device (see the module docstring)."""
    if devices is None:
        n_cuda = torch.cuda.device_count()
        if n_cuda == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices=")
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devices = [canonical_device(d) for d in devices]
    n = len(devices)
    if model_parallel <= 0:
        raise ValueError("model_parallel must be >= 1")
    if data_parallel == -1:
        if n % model_parallel != 0:
            raise ValueError(
                f"{n} devices not divisible by model_parallel={model_parallel}")
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(
            f"data_parallel*model_parallel = {data_parallel * model_parallel} "
            f"!= {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(data_parallel, model_parallel))


def shard_batch(mesh: Mesh, array, axis: int = 0) -> List[torch.Tensor]:
    """Split ``array`` (numpy or torch) into ``mesh.shape[DATA_AXIS]``
    equal contiguous pieces along ``axis``, piece ``i`` on
    ``mesh.shard_devices[i]``. The axis must divide; callers pad (ids
    travel with vectors, so repeated samples are benign)."""
    n = mesh.shape[DATA_AXIS]
    size = array.shape[axis]
    if size % n:
        raise ValueError(f"axis {axis} of size {size} does not split over "
                         f"{n} data shards")
    step = size // n
    out = []
    for i, dev in enumerate(mesh.shard_devices):
        idx = [slice(None)] * array.ndim
        idx[axis] = slice(i * step, (i + 1) * step)
        piece = array[tuple(idx)]
        if not isinstance(piece, torch.Tensor):
            piece = torch.from_numpy(np.ascontiguousarray(piece))
        out.append(piece.to(dev).contiguous())
    return out


def replicated(mesh: Mesh, tree) -> list:
    """One copy of ``tree`` (a numpy array, or a tree of tensors and
    quantized weights: ``models.quantization.tree_to``) per data
    shard, entry ``i`` on ``mesh.shard_devices[i]``. Shards on one device
    share one copy, and a tensor already on a device is used as it is
    there."""
    from mllm_sparse_retrieval_tpu_torch.models.quantization import tree_to

    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    copies = {}
    out = []
    for dev in mesh.shard_devices:
        if dev not in copies:
            copies[dev] = tree_to(tree, dev)
        out.append(copies[dev])
    return out

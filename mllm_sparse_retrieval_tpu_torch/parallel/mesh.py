"""Device meshes for one process (the JAX package's ``parallel/mesh.py``).

A ``Mesh`` is an array of torch devices with named axes (``[data,
model]`` from ``make_mesh``). One Python process drives every shard: a
data-sharded batch is a list of per-shard tensors, shard ``i`` on
``mesh.shard_devices[i]``, each its own contiguous tensor, and a leaf
split over an axis (a parameter under tensor parallelism or FSDP, an
optimizer moment under ZeRO-1) is a ``Sharded``: its pieces, their
devices and its spec. The JAX package's ``shard_map`` becomes a loop over
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

Under a process group (``parallel.multihost.initialize_multihost``),
``make_mesh`` builds a mesh whose data axis spans the processes, as the JAX
package's global mesh spans its hosts: each process holds the grid of its
own devices (``devices``, ``shape``, ``shard_devices`` and ``row(i)`` are
local), ``process_index`` and ``processes`` place it in the group,
``data_size`` is the global data axis (processes x local data shards) and
``data_offset`` the global index of the process's first data shard. The
model axis stays inside a process. A ``Sharded`` split over such a data
axis holds the process's own pieces and gathers the rest through
``multihost.all_gather_rows``. Only the trainer (``train/trainer.py``) and
the sharded loss read the global axis; the other sharded programs run on
the process's local grid.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

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
    """A grid of devices with named axes (the JAX package's
    ``jax.sharding.Mesh``): ``(data, model)`` from ``make_mesh``, ``(data,
    pipe)`` and ``(data, pipe, model)`` from ``parallel/pp.py``.

    ``shape`` maps each axis name to its size, as a JAX mesh's does. Shard
    ``i`` of a data-sharded tensor lives on ``shard_devices[i]`` (the first
    device of data index ``i``); merged results land on ``lead`` (the first
    device of the grid). Equality is identity, as caches keyed on a mesh
    expect. ``process_index`` / ``processes`` place the grid in a data axis
    across processes (see the module docstring)."""

    def __init__(self, devices: np.ndarray,
                 axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
                 process_index: int = 0, processes: int = 1):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh devices of shape {devices.shape} do not "
                             f"match the axes {axis_names}")
        if axis_names[0] != DATA_AXIS:
            raise ValueError(f"the first mesh axis is {DATA_AXIS!r}, got "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.process_index = process_index
        self.processes = processes

    @property
    def data_size(self) -> int:
        """The global data axis: the processes' data shards together."""
        return int(self.devices.shape[0]) * self.processes

    @property
    def data_offset(self) -> int:
        """The global index of this process's first data shard."""
        return int(self.devices.shape[0]) * self.process_index

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        return self.devices.flat[0]

    @property
    def shard_devices(self) -> List[torch.device]:
        rest = (0,) * (self.devices.ndim - 1)
        return [self.devices[(i,) + rest]
                for i in range(self.devices.shape[0])]

    def axis_devices(self, axis: str, at: Optional[Dict[str, int]] = None
                     ) -> List[torch.device]:
        """The devices along ``axis`` with every other axis at its index in
        ``at`` (0 where ``at`` does not name it)."""
        at = at or {}
        k = self.axis_names.index(axis)
        out = []
        for j in range(self.devices.shape[k]):
            idx = tuple(j if n == axis else at.get(n, 0)
                        for n in self.axis_names)
            out.append(self.devices[idx])
        return out

    def row(self, i: int) -> "Mesh":
        """The mesh of data shard ``i`` (its other axes' devices, the data
        axis of size 1), cached so a row is one object across calls."""
        rows = self.__dict__.setdefault("_rows", {})
        if i not in rows:
            rows[i] = Mesh(self.devices[i:i + 1], self.axis_names)
        return rows[i]

    def __repr__(self) -> str:
        across = "" if self.processes == 1 else (
            f", process {self.process_index} of {self.processes}")
        return (f"Mesh({dict(self.shape)}, "
                f"{[str(d) for d in self.devices.flat]}{across})")


def grid(devices: Sequence, shape: Sequence[int]) -> np.ndarray:
    """``devices`` (canonical spellings) as an object array of ``shape``."""
    out = np.empty(len(devices), dtype=object)
    out[:] = [canonical_device(d) for d in devices]
    return out.reshape(tuple(shape))


class Sharded:
    """A tensor split over one mesh axis: the counterpart of a JAX array
    placed with a ``NamedSharding``.

    ``pieces[j]`` is the ``j``-th of equal contiguous pieces along ``dim``
    and lives on ``devices[j]``; ``spec`` is the whole tensor's
    ``PartitionSpec`` read as a tuple (``(None, "model")``: dim 1 split over
    the model axis). A piece may itself be ``Sharded`` over another axis
    (FSDP on a tensor-parallel leaf). The pieces are the tensors that
    autograd and the optimizer see; ``gather(device)`` concatenates them
    there, differentiably, so gradients land on the pieces. Never changed
    in place by the functions that make it.

    Split over a data axis across processes (``processes`` > 1), ``pieces``
    are this process's: global pieces ``process_index * len(pieces)`` on.
    ``gather`` then concatenates them on the first piece's device, gathers
    every process's block there (``multihost.all_gather_rows``: each
    piece's gradient summed over the processes lands on it) and moves the
    whole to ``device``; every process gathers in the same order."""

    def __init__(self, pieces: Sequence, devices: Sequence, dim: int,
                 spec: Tuple, process_index: int = 0, processes: int = 1):
        self.pieces = list(pieces)
        self.devices = [canonical_device(d) for d in devices]
        self.dim = dim
        self.spec = tuple(spec)
        self.process_index = process_index
        self.processes = processes

    @property
    def axis(self) -> str:
        """The mesh axis ``dim`` is split over."""
        return self.spec[self.dim]

    @property
    def shape(self) -> torch.Size:
        first = self.pieces[0]
        s = list(first.shape)
        s[self.dim] *= len(self.pieces) * self.processes
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def tensors(self) -> List[torch.Tensor]:
        """The tensors that hold the data, pieces of pieces flattened."""
        return [t for p in self.pieces for t in
                (p.tensors() if isinstance(p, Sharded) else [p])]

    @property
    def piece_offset(self) -> int:
        """The global index of ``pieces[0]``."""
        return self.process_index * len(self.pieces)

    def gather(self, device) -> torch.Tensor:
        """The whole tensor on ``device`` (differentiable)."""
        if self.processes == 1:
            return torch.cat([as_tensor(p, device) for p in self.pieces],
                             dim=self.dim)
        from mllm_sparse_retrieval_tpu_torch.parallel.multihost import (
            all_gather_rows)

        here = self.devices[0]
        local = torch.cat([as_tensor(p, here) for p in self.pieces],
                          dim=self.dim)
        return all_gather_rows(local, self.dim).to(device)

    def __repr__(self) -> str:
        across = "" if self.processes == 1 else (
            f", process {self.process_index} of {self.processes}")
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, spec="
                f"{self.spec}, on {[str(d) for d in self.devices]}{across})")


def as_tensor(x, device) -> torch.Tensor:
    """``x`` (a tensor or ``Sharded``) whole on ``device``."""
    if isinstance(x, Sharded):
        return x.gather(device)
    return x.to(device)


def split(x: torch.Tensor, dim: int, devices: Sequence,
          spec: Tuple, mesh: Optional[Mesh] = None) -> Sharded:
    """``x`` cut into ``len(devices)`` equal pieces along ``dim`` (over the
    axis ``spec[dim]``), piece ``j`` a new contiguous tensor on
    ``devices[j]``: the caller's tensor is never aliased, so updating a
    piece in place leaves it as it was. Over the data axis of a ``mesh``
    that spans processes, ``x`` (the same whole tensor in every process)
    is cut into ``len(devices) * mesh.processes`` pieces and this process
    keeps its own."""
    procs, index = 1, 0
    if mesh is not None and spec[dim] == DATA_AXIS:
        procs, index = mesh.processes, mesh.process_index
    n = len(devices) * procs
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} devices of {spec[dim]!r}")
    step = x.shape[dim] // n
    first = index * len(devices)
    with torch.no_grad():
        pieces = [x.narrow(dim, (first + j) * step, step).to(d, copy=True)
                  .contiguous() for j, d in enumerate(devices)]
    return Sharded(pieces, devices, dim, spec, index, procs)


def spec_axes(spec: Tuple) -> set:
    """The mesh axes a spec tuple uses."""
    return {a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}


def make_mesh(data_parallel: int = -1, model_parallel: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a 2-D ``(data, model)`` mesh.

    ``devices=None`` takes every CUDA device (one card gives a 1x1 mesh,
    on which every sharded program still runs); ``data_parallel=-1``
    takes all devices not consumed by ``model_parallel``. ``devices`` may
    repeat a device (see the module docstring).

    Under an initialised process group the data axis spans the processes:
    ``devices`` are this process's (``None``: its cards,
    ``multihost.local_devices``), ``data_parallel`` counts the global data
    axis (processes x local data shards), and the model axis must fit in
    one process's devices, as the JAX package's ``(data, model)`` reshape
    keeps a model row's devices together."""
    from mllm_sparse_retrieval_tpu_torch.parallel.multihost import (
        local_devices, process_view)

    view = process_view()
    if devices is None:
        if torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices=")
        devices = (local_devices() if view.world_size > 1 else
                   [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())])
    devices = [canonical_device(d) for d in devices]
    n = len(devices)
    procs = view.world_size
    if model_parallel <= 0:
        raise ValueError("model_parallel must be >= 1")
    if procs > 1 and n % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} does not fit in the {n} "
            f"devices of one process: the model axis stays inside a "
            f"process")
    if data_parallel == -1:
        if n % model_parallel != 0:
            raise ValueError(
                f"{n} devices not divisible by model_parallel={model_parallel}")
        data_parallel = n // model_parallel * procs
    if data_parallel % procs:
        raise ValueError(f"a data axis of {data_parallel} does not split "
                         f"over {procs} processes")
    if data_parallel // procs * model_parallel != n:
        raise ValueError(
            f"data_parallel*model_parallel = {data_parallel * model_parallel} "
            f"!= {n * procs} devices")
    return Mesh(grid(devices, (data_parallel // procs, model_parallel)),
                process_index=view.rank, processes=procs)


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


def tree_map(fn, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts and lists (tuples become
    lists); ``path`` holds the dict keys and list indices down to the
    leaf, as ``jax.tree_util.tree_map_with_path`` gives them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_at(tree, path: Tuple):
    """The subtree of ``tree`` at ``path`` (as ``tree_map`` gives it)."""
    for k in path:
        tree = tree[k]
    return tree


def leaf_spec(x) -> Tuple:
    """A leaf's spec padded to its rank: a ``Sharded``'s own, else every
    dim unsplit."""
    ndim = len(getattr(x, "shape", ()))
    spec = tuple(x.spec) if isinstance(x, Sharded) else ()
    return spec + (None,) * (ndim - len(spec))

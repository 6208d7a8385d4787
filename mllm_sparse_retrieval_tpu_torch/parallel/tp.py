"""Tensor parallelism over the mesh's model axis (the JAX package's
``parallel/tp.py``): the megatron layout of the parameter tree.

- attention q / k / v, the FFN's gate / up, the ViT's qkv / fc1: the
  output dim split, ``(None, "model")``;
- attention o, the FFN's down, the ViT's out / fc2: the input dim split,
  ``("model", None)``;
- everything else whole.

A split weight is a ``parallel.mesh.Sharded`` whose pieces live on the
model-axis devices of the mesh's first data row; ``layers.dense`` runs it
in the megatron form (a column split concatenates each device's output
columns, a row split sums each device's partial product on the input's
device), where the JAX package lets GSPMD insert the all-reduces. A dim the
axis does not divide stays whole, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

from mllm_sparse_retrieval_tpu_torch.parallel.mesh import (
    MODEL_AXIS, Mesh, split, tree_at, tree_map)

_COL_SHARDED = {"q", "k", "v", "gate", "up", "qkv", "fc1"}   # [in, out@model]
_ROW_SHARDED = {"o", "down", "out", "fc2"}                    # [in@model, out]


def _spec_for(path, leaf) -> tuple:
    names = [str(n) for n in path]
    if len(getattr(leaf, "shape", ())) != 2:
        return ()
    # .../blocks/<i>/<proj>/w
    if len(names) >= 2 and names[-1] == "w":
        if names[-2] in _COL_SHARDED:
            return (None, MODEL_AXIS)
        if names[-2] in _ROW_SHARDED:
            return (MODEL_AXIS, None)
    return ()


def tp_param_shardings(params: Dict, mesh: Mesh):
    """Spec tuples of the megatron layout; a leaf whose split dim the model
    axis does not divide is whole (``()``)."""
    n = mesh.shape[MODEL_AXIS]

    def make(path, leaf):
        spec = _spec_for(path, leaf)
        for axis, name in enumerate(spec):
            if name == MODEL_AXIS and leaf.shape[axis] % n != 0:
                return ()
        return spec

    return tree_map(make, params)


def shard_params_tp(params: Dict, mesh: Mesh) -> Dict:
    """A new tree with the split weights ``Sharded`` over the model axis
    (new tensors on the model-axis devices); the other leaves are the
    caller's. The caller's tree is not changed."""
    specs = tp_param_shardings(params, mesh)
    devices = mesh.axis_devices(MODEL_AXIS)

    def place(path, x):
        spec = tree_at(specs, path)
        if MODEL_AXIS not in spec:
            return x
        return split(x, spec.index(MODEL_AXIS), devices, spec)

    return tree_map(place, params)

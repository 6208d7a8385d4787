"""Random weights drawn on the card from the seed, in a few large calls.

The tree's layout (paths, shapes, dtypes) is the port's parameter layout,
read by running the port's ``registry.init_params`` under
``FakeTensorMode`` (no memory is allocated and nothing is drawn). The
values are the benchmark's own: one flat buffer in the served dtype,
filled by ``normal_`` from a generator on the device in chunks, each
leaf a view of it scaled by its kind. The port and the reference get the
same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 28              # elements per normal_ call
ALIGN = 128                  # leaf offsets in elements (256 bytes in bf16),
                             # so every leaf is as aligned as its own tensor


def _walk(tree, path=()):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))


def layout(arch) -> Tuple[object, List[Tuple[tuple, torch.Size]]]:
    """(the tree with fake leaves, [(path, shape)]) of the port's
    parameters for ``arch``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from mllm_sparse_retrieval_tpu_torch.models import registry

    with FakeTensorMode():
        gen = torch.Generator(device="cpu").manual_seed(0)
        tree = registry.init_params(arch, gen, "cpu", torch.bfloat16)
    return tree, [(p, t.shape) for p, t in _walk(tree)]


def _init(path, view: torch.Tensor) -> None:
    """Scale a standard-normal leaf by its kind: dense ``w`` by
    1/sqrt(fan_in), norm scales 1, layer scales 0.1, biases and
    embeddings 0.02."""
    name = path[-1]
    if name == "scale":
        view.fill_(1.0)
    elif name in ("lambda1", "lambda2"):
        view.fill_(0.1)
    elif name == "w" and view.dim() == 2:
        view.mul_(1.0 / math.sqrt(view.shape[0]))
    else:
        view.mul_(0.02)


def draw(arch, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The port's parameter tree for ``arch`` with values drawn from
    ``seed`` on ``device``."""
    skeleton, leaves = layout(arch)
    offsets, total = [], 0
    for _, shape in leaves:
        offsets.append(total)
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    buf = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for c0 in range(0, total, CHUNK):
        buf[c0:c0 + CHUNK].normal_(generator=gen)
    views = {}
    for (path, shape), off in zip(leaves, offsets):
        v = buf[off:off + math.prod(shape)].view(shape)
        _init(path, v)
        views[path] = v

    def build(tree, path=()):
        if isinstance(tree, torch.Tensor):
            return views[path]
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        return [build(v, path + (i,)) for i, v in enumerate(tree)]

    return build(skeleton)


"""Parallel layers: device meshes for one process (``mesh.py``: search,
encode and serve over a data-axis mesh) and the mixture-of-experts FFN on
one device (``ep.py``). Training over a mesh waits for ROADMAP Queue 1
#9b."""

from mllm_sparse_retrieval_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, make_mesh, replicated, shard_batch)
from mllm_sparse_retrieval_tpu_torch.parallel.ep import (
    MoEConfig, expert_capacity, moe_ffn, moe_init)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "MoEConfig",
           "expert_capacity", "make_mesh", "moe_ffn", "moe_init",
           "replicated", "shard_batch"]

"""Parallel layers: device meshes and leaves split over their axes
(``mesh.py``; a data axis may span processes), FSDP (``fsdp.py``), tensor
(``tp.py``), sequence (``sp.py``), pipeline (``pp.py``) and expert
(``ep.py``) parallelism, the process group and its collectives
(``multihost.py``) and the dry run of all of them (``dryrun.py``)."""

from mllm_sparse_retrieval_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, Sharded, make_mesh, replicated,
    shard_batch)
from mllm_sparse_retrieval_tpu_torch.parallel.ep import (
    MoEConfig, expert_capacity, moe_ffn, moe_init, shard_moe_params)
from mllm_sparse_retrieval_tpu_torch.parallel.pp import (
    PIPE_AXIS, make_pp3_mesh, make_pp_mesh)
from mllm_sparse_retrieval_tpu_torch.parallel.sp import (
    apply_sequence_parallel, ring_attention)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "MoEConfig", "PIPE_AXIS",
           "Sharded", "apply_sequence_parallel", "expert_capacity",
           "make_mesh", "make_pp3_mesh", "make_pp_mesh", "moe_ffn",
           "moe_init", "replicated", "ring_attention", "shard_batch",
           "shard_moe_params"]

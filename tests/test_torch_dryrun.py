"""PyTorch port, the dry run of every parallel form
(``parallel/dryrun.py``, the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``): all eight legs at their tiny shapes
over 8 shards of the CPU, each leg's own checks (finite losses, FSDP
leaves split, sharded search equal to unsharded, the pipelines, ring
attention and expert parallelism against their sequential forms within
the JAX dry run's tolerances), and which devices it takes."""

import torch

from mllm_sparse_retrieval_tpu_torch.parallel.dryrun import (
    dryrun_devices, dryrun_multichip)


def test_dryrun_multichip_passes_on_the_cpu(capsys):
    line = dryrun_multichip(8, device="cpu")
    assert capsys.readouterr().out.strip() == line
    for part in ("mesh={'data': 4, 'model': 2}", "data-sharded",
                 "sharded TAAT+MIPS (f32+int8+ANN) parity OK",
                 "mesh fused-hybrid parity OK", "dp2xpp4 pipelined step",
                 "dp x pp x tp pipeline parity OK",
                 "seq-parallel ring-attention parity OK",
                 "expert-parallel MoE (E=4 over model axis) parity OK"):
        assert part in line, part
    assert " 0 param leaves" not in line and " 0 moments" not in line


def test_dryrun_repeats_one_device_when_short():
    assert dryrun_devices(4, "cpu") == [torch.device("cpu")] * 4
    if torch.cuda.device_count() < 8:
        assert dryrun_devices(8) == [torch.device("cuda", 0)] * 8

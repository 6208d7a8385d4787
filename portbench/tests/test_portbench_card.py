"""On the card only (they skip elsewhere, deciding inside the test): a
cell's run as the benchmark makes it, and the control against the cell's
limits at the cell's own size."""

import json
import subprocess
import sys

import pytest

from portbench import control, core


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_the_serving_cell_runs_correct():
    _card()
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "qwen2_5_vl_7b.serve_text", "--seed", "4242424242", "--seconds",
         "3", "--trace", "0"], cwd=core.ROOT, capture_output=True,
        text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"query_p95_ms", "queries_per_s",
                                    "setup_s"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in
                                  core.benchmark()["workloads"]])
def test_the_control_is_not_correct(cell):
    _card()
    bench = core.benchmark()
    readings = control.readings(bench, core.cell(bench, cell), 5151, 10.0,
                                "cuda")
    limits = core.limits(cell)
    assert any(readings[k] > limits[k] for k in limits), readings

"""Each cell end to end on the CPU at a tiny size: the plain reference
agrees with the port, the float8 control reads well above the program,
and a fault planted in the timed path turns ``correct`` false."""

import pytest
import torch

from portbench import control, core, faults
from portbench.tests import tiny_cells

CELLS = list(tiny_cells.CELLS)
# bf16 through two tiny layers reads 0.01-0.05 on every number here; a
# wrong reference or a broken path reads 0.3 and more
TINY_AGREE = 0.1


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_agrees_with_the_port(cell):
    out = tiny_cells.run_tiny(cell)
    assert out.failed == 0 and out.attempted > 0
    assert out.checks
    for c in out.checks:
        assert c.value < TINY_AGREE, (c.name, c.value)
    assert out.e2e["setup_s"] >= 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_above_the_program(cell):
    bench, cell_e, cfg, mix = tiny_cells.tiny(cell)
    program = {c.name: c.value for c in tiny_cells.run_tiny(cell).checks}
    ctrl = control.readings(bench, cell_e, 12345678901, 1.0, "cpu",
                            config=cfg, mix=mix)
    assert max(ctrl[k] / max(program[k], 1e-6) for k in program) > 3.0, \
        (ctrl, program)


@pytest.mark.parametrize("cell", CELLS)
def test_a_wrong_representation_position_is_not_correct(cell,
                                                        monkeypatch):
    from mllm_sparse_retrieval_tpu_torch.models import reps

    right = reps.select_rep_positions

    def off_by_one(mask, loc):
        return (right(mask, loc) - 1).clamp(min=0)

    monkeypatch.setattr(reps, "select_rep_positions", off_by_one)
    out = tiny_cells.run_tiny(cell)
    assert not out.correct
    assert any(c.value > c.limit for c in out.checks)


@pytest.mark.parametrize("cell,fault", [
    ("qwen2_5_vl_7b.serve_text", "answer_altered"),
    ("qwen2_5_vl_7b.index_images", "answer_altered"),
    ("internvl2_5_4b.index_images", "answer_altered"),
    ("internvl2_5_4b.train_lora", "half_batch"),
    ("internvl2_5_4b.train_lora", "state_unchanged"),
])
def test_a_planted_fault_is_not_correct(cell, fault):
    with faults.FAULTS[fault]():
        out = tiny_cells.run_tiny(cell)
    assert not out.correct
    if fault == "state_unchanged":
        change = {c.name: c.value for c in out.checks}["change_gap"]
        assert change == pytest.approx(1.0)


def test_a_failed_query_is_not_correct(monkeypatch):
    """Every third micro-batch of the window fails."""
    from mllm_sparse_retrieval_tpu_torch.serving import service

    from portbench.kinds import serve_text

    right = service.RetrievalService._run_uniform
    warm = serve_text.warm_up
    calls = []

    def warmed(st):
        warm(st)
        calls.append(0)

    def failing(self, reqs, name):
        if calls:
            calls.append(1)
            if len(calls) % 3 == 0:
                raise RuntimeError("planted")
        return right(self, reqs, name)

    monkeypatch.setattr(serve_text, "warm_up", warmed)
    monkeypatch.setattr(service.RetrievalService, "_run_uniform", failing)
    out = tiny_cells.run_tiny("qwen2_5_vl_7b.serve_text")
    assert out.failed > 0 and not out.correct
    assert out.e2e["query_p95_ms"] > 0


def test_the_result_line_puts_the_checks_last():
    import json

    out = core.Outcome(attempted=3, failed=0, e2e={}, checks=[
        core.Check("regret", 0.01, 0.05)], memory_peak_bytes=1)
    line = core.result_line(out, {"setup_s": {"value": 1.0, "unit": "s"}},
                            {"platform": "gpu"}, False)
    parsed = json.loads(line)
    assert list(parsed)[-1] == "checks" and parsed["correct"] is True
    out.checks.append(core.Check("score_gap", float("nan"), 1.0))
    assert not out.correct

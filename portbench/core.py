"""What every cell's run shares: where the files are, how a cell, its
configuration, its mix, its limits and its metric readers are found by
name, the guard against JAX, and the result line.

Nothing here imports torch at module level, so the lookup can be tested
and the JAX guard can run before the port is loaded.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that nothing the benchmark runs may load
FORBIDDEN = ("jax", "jaxlib", "flax", "mllm_sparse_retrieval_tpu",
             "chip_smoke", "bench")
PORT = "mllm_sparse_retrieval_tpu_torch"


def process_age_s() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat`` against ``/proc/uptime``); 0 where unreadable."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so only
    the first run of a checkout builds (the port's own nvcc and g++ builds
    already live under its package directory)."""
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for c in bench["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    """The cell's comparison limits (``limits/<cell>.json``)."""
    return load_json(BENCH_DIR / "limits" / f"{cell_name}.json")


def kind_module(kind: str):
    """The generator and runner of a mix kind: ``kinds/<kind>.py``."""
    return importlib.import_module(f"portbench.kinds.{kind}")


def metric_reader(name: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``, loaded by
    path (a metric's name may hold dots)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def e2e_metrics(bench: dict, cell_name: str) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer_metrics(bench: dict, cell_name: str) -> List[dict]:
    moves = {m["name"] for m in e2e_metrics(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]


def forbidden_loaded() -> List[str]:
    """Modules in ``sys.modules`` whose top-level name (before the first
    dot, compared whole) is one of ``FORBIDDEN``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclass
class RunContext:
    """One run's inputs: the parsed files of its cell and the command's
    arguments. ``t_start`` is the process's start on the
    ``time.perf_counter`` clock (``setup_s`` counts from it)."""
    bench: dict
    cell: dict
    config: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float


def context(bench: dict, cell: dict, seed: int, seconds: float,
            trace: bool, device: str, t_start: float, config_data=None,
            mix_data=None) -> RunContext:
    """A run's context from its cell's files; ``config_data`` and
    ``mix_data`` replace the files' contents (the CPU tests run tiny
    ones)."""
    return RunContext(
        bench=bench, cell=cell,
        config=(config_data if config_data is not None
                else config(cell["config"])),
        mix=mix_data if mix_data is not None else mix(cell["traffic"]),
        limits=limits(cell["name"]), seed=int(seed), seconds=float(seconds),
        trace=bool(trace), device=device, t_start=t_start)


@dataclass
class Check:
    """One number of the comparison with the reference and its limit: the
    run is correct only where every value is finite and at most its
    limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a kind's run hands back: the judged counts, the end-to-end
    metrics by name, what the per-layer readers read (``layer``), the
    device fields and the checks."""
    attempted: int
    failed: int
    e2e: Dict[str, float]
    checks: List[Check]
    memory_peak_bytes: int
    layer: Optional[dict] = None
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    notes: List[str] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(c.ok for c in self.checks)


def log(msg: str) -> None:
    print(f"[portbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def result_line(out: Outcome, metrics: Dict[str, dict], device: dict,
                trace: bool) -> str:
    """The result's JSON line; the compared numbers come last, each with
    its limit."""
    line = {"correct": bool(out.correct), "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": device}
    if trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    return json.dumps(line)


def print_checks(checks: List[Check]) -> None:
    """Each compared number beside its limit: the last lines on stderr."""
    for c in checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)

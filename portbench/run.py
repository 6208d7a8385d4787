"""Run one cell of ``BENCHMARK.json`` once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads and warms up what the cell needs (counted as ``setup_s``), measures
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last on stdout: the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``.
Exits non-zero, printing no result, without enough CUDA cards, or if a JAX
module or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import core  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    t_start = time.perf_counter() - core.process_age_s()
    args = parse(argv)
    core.cache_env()
    bench = core.benchmark()
    cell = core.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"found {found}", file=sys.stderr)
        return 2
    out = execute(bench, cell, args.seed, args.seconds, bool(args.trace),
                  "cuda", t_start)
    leaked = core.forbidden_loaded()
    if leaked:
        print(f"portbench: forbidden modules loaded: {leaked}",
              file=sys.stderr)
        return 3
    metrics = collect_metrics(bench, cell["name"], out, bool(args.trace))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]),
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    if args.trace:
        device["busy_s"] = out.busy_s
        device["window_s"] = out.window_s
    core.log(f"card: {card_line()}")
    for note in out.notes:
        core.log(note)
    core.print_checks(out.checks)
    print(core.result_line(out, metrics, device, bool(args.trace)),
          flush=True)
    return 0


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi did not answer"


def execute(bench, cell, seed, seconds, trace, device, t_start,
            config=None, mix=None):
    """One run of ``cell`` on ``device`` (the look for a card is the
    caller's): its kind's ``run``. ``config`` and ``mix`` replace the
    files' contents (the CPU tests run tiny ones)."""
    ctx = core.context(bench, cell, seed, seconds, trace, device, t_start,
                       config, mix)
    return core.kind_module(ctx.mix["kind"]).run(ctx)


def collect_metrics(bench, cell_name, out, trace):
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    metrics that their readers found something for."""
    metrics = {}
    if not trace:
        for m in core.e2e_metrics(bench, cell_name):
            if m["name"] in out.e2e:
                metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                      "unit": m["unit"]}
        return metrics
    for m in core.per_layer_metrics(bench, cell_name):
        value = core.metric_reader(m["name"]).read(out.layer or {})
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


if __name__ == "__main__":
    sys.exit(main())

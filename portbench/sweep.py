"""Offered-rate sweep of a serving cell on one warm service: the highest
rate the program sustains without a growing backlog, which a mix file then
fixes (at about four fifths of it).

    python3 -m portbench.sweep --workload <cell> --seed <n> \
        --seconds <s> --rates <q/s> [<q/s> ...]

Prints one JSON line a rate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import core  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    core.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("portbench.sweep: no CUDA card", file=sys.stderr)
        return 2
    bench = core.benchmark()
    cell = core.cell(bench, args.workload)
    ctx = core.context(bench, cell, args.seed, args.seconds, False, "cuda",
                       time.perf_counter())
    for row in core.kind_module(ctx.mix["kind"]).sweep(ctx, args.rates):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The control of a cell's comparison: the plain reference computed one
precision below the configuration's (float8 for bfloat16) in the
program's place, judged by the float32 reference on the queries or steps a
run of each seed checks. Its readings set the upper end of each limit.

    python3 -m portbench.control --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

Prints one JSON line a seed. Runs on the card; the benchmark's own runs
never run it.
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


def readings(bench, cell, seed, seconds, device, config=None, mix=None):
    ctx = core.context(bench, cell, seed, seconds, False, device,
                       time.perf_counter(), config, mix)
    return core.kind_module(ctx.mix["kind"]).control(ctx)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    core.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    bench = core.benchmark()
    cell = core.cell(bench, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(bench, cell, seed, args.seconds, "cuda")
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "control": out,
                          "seconds": time.perf_counter() - t0}), flush=True)
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Faults planted in the port's timed path, for showing that a cell's
check catches them: the CPU tests plant each at a tiny size, and on the
card

    python3 -m portbench.faults --workload <cell> --fault <name> \
        --seconds <s> --seeds <n> [<n> ...]

runs the cell with the fault planted and prints its checks, one JSON line
a seed. The benchmark's own runs never plant one.

- ``answer_altered``: served text answers: the first query of each
  micro-batch gets another doc in place of its top one; image answers:
  each batch's answers shifted by one image as they are resolved;
- ``half_batch``: the contrastive loss over half of the batch's rows, the
  mean taken over them;
- ``state_unchanged``: a training step that leaves the adapters and the
  optimizer's state as they were.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import core  # noqa: E402


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def answer_altered():
    from mllm_sparse_retrieval_tpu_torch.pipelines import encode
    from mllm_sparse_retrieval_tpu_torch.serving import service

    serve = service.RetrievalService._run_uniform
    resolve = encode.resolve_image_ds_rows

    def altered(self, reqs, name):
        rows = serve(self, reqs, name)
        doc, score = rows[0][0]
        n = len(self.dense_index.lookup)
        rows[0] = [(str((int(doc) + 1) % n), score)] + rows[0][1:]
        return rows

    def shifted(parts, valid, cfg):
        rows = resolve(parts, valid, cfg)
        return rows[1:] + rows[:1]

    with _patched(service.RetrievalService, "_run_uniform", altered), \
            _patched(encode, "resolve_image_ds_rows", shifted):
        yield


@contextlib.contextmanager
def half_batch():
    from mllm_sparse_retrieval_tpu_torch.train import trainer

    loss = trainer.info_nce_loss

    def half(t, i, tau):
        n = t.shape[0] // 2
        return loss(t[:n], i[:n], tau)

    with _patched(trainer, "info_nce_loss", half):
        yield


@contextlib.contextmanager
def state_unchanged():
    from mllm_sparse_retrieval_tpu_torch.train import trainer

    with _patched(trainer.ContrastiveTrainer, "_update",
                  lambda self, leaves, grads: None):
        yield


FAULTS = {"answer_altered": answer_altered, "half_batch": half_batch,
          "state_unchanged": state_unchanged}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.faults")
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=sorted(FAULTS))
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    core.cache_env()
    import torch

    from portbench import run

    if not torch.cuda.is_available():
        print("portbench.faults: no CUDA card", file=sys.stderr)
        return 2
    bench = core.benchmark()
    cell = core.cell(bench, args.workload)
    for seed in args.seeds:
        with FAULTS[args.fault]():
            out = run.execute(bench, cell, seed, args.seconds, False,
                              "cuda", time.perf_counter())
        print(json.dumps({"workload": cell["name"], "fault": args.fault,
                          "seed": seed, "correct": out.correct,
                          "checks": {c.name: c.value for c in out.checks}}),
              flush=True)
        import gc
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

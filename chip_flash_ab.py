#!/usr/bin/env python3
"""Time the TAAT and flash-attention kernels of one or more checkouts in
turns, on one NVIDIA card.

    python3 chip_flash_ab.py ROOT [ROOT ...] [--fwd-only]

Each ROOT is a checkout of this repository (for example the parent commit
unpacked with ``git archive`` beside the working tree). For each ROOT, in
the order given, a fresh process builds that checkout's kernels and runs
its own ``chip_smoke.py`` checks, each holding a kernel against its plain
version and timing it: the TAAT kernel at the bench shape
(``phase_kernel_bench``, int16 and f32) and at the served text shape (8
queries of 64 slots, 4-8 live Zipf terms each, over an int16 [17014, 26624]
matrix, drawn here from a seed, so every root gets the same inputs; then
the first of those queries alone), with the replay floor of the smallest
launch beside it; then the flash forward
(``phase_flash``) and, unless ``--fwd-only``, the dq and dkv kernels
(``phase_flash_bwd``), on the synthetic rows of ``chip_smoke.py`` (3,072
tokens, one all-pad row) and on the rows of its profiled training step.
Give a root twice (A B B A) to see the spread. One line per root
summarises the kernel times; the checks' own lines are printed above it.
Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import re
import subprocess
import sys

_CHILD = r"""
import dataclasses, os, sys
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import numpy as np
import torch
import chip_smoke as cs
from mllm_sparse_retrieval_tpu_torch.configs import ModelFamily
from mllm_sparse_retrieval_tpu_torch.models import anyres, templates
from mllm_sparse_retrieval_tpu_torch.models.registry import get_family_spec
from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
    WordPieceLiteTokenizer)
from mllm_sparse_retrieval_tpu_torch.ops.impact_kernel import (
    prepare_query_arrays)
cs.build_kernels()
# the prompt lengths chip_smoke.main computes, from the same draws
rng = np.random.default_rng(cs.SEED)
cs.phase_kernel_bench(rng)
# TAAT at the served text shape
terms, n_pad, b, q = 17013, 26624, 8, 64
srng = np.random.default_rng(cs.SEED + 6)
gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)
matrix = torch.randint(0, 350, (terms + 1, n_pad), generator=gen,
                       device="cuda", dtype=torch.int16)
matrix[0] = 0
q_idx, q_w = np.zeros((b, q), np.int64), np.zeros((b, q), np.float32)
for i in range(b):
    n = int(srng.integers(4, 9))
    q_idx[i, :n] = srng.choice(terms, size=n, p=cs.zipf_p(terms))
    q_w[i, :n] = srng.integers(1, 300, size=n)
safe_idx, safe_w = (torch.from_numpy(a).cuda()
                    for a in prepare_query_arrays(q_idx, q_w))
cs.check_kernel(f"served shape {tuple(matrix.shape)} int16, B={b} Q={q}",
                matrix, safe_idx, safe_w, iters=200)
cs.check_kernel(f"served shape {tuple(matrix.shape)} int16, B=1 Q={q}",
                matrix, safe_idx[:1], safe_w[:1], iters=200)
tiny = torch.empty(8, device="cuda")
cs.progress("kernel", f"replay floor of the smallest launch "
            f"{cs.device_ms(tiny.zero_, 200):.4f} ms")
del matrix, safe_idx, safe_w
torch.cuda.empty_cache()
lexicon = cs.synthetic_lexicon(rng, cs.VOCAB_WORDS)
tok = WordPieceLiteTokenizer.from_corpus_captions(
    cs.captions(rng, lexicon, 20_000, 8, 14), vocab_size=cs.VOCAB_WORDS)
spec = get_family_spec(ModelFamily.LLAVA_NEXT_LLAMA3)
tmpl = templates.TINY
arch = dataclasses.replace(spec.arch, image_token_id=tok.image_token_id)
lens = [len(tok.encode(tmpl.expand_image(
    tmpl.image_prompt(), anyres.num_image_tokens(
        size, arch.grid_pinpoints, arch.vision.image_size,
        arch.patches_per_side)))) for size in cs.IMAGE_SIZES]
n = len(cs.IMAGE_SIZES)
train = [lens[(3 * i) % n] for i in range((cs.TRAIN_STEPS - 1) * cs.TRAIN_B,
                                          cs.TRAIN_STEPS * cs.TRAIN_B)]
seq = 3072
cs.phase_flash(lens[:cs.FLASH_B - 1] + [0], seq)
cs.phase_flash(train, seq)
if sys.argv[2] != "fwd":
    cs.phase_flash_bwd(lens[:cs.TRAIN_B - 1] + [0], seq)
    cs.phase_flash_bwd(train, seq)
"""


def summary(out: str) -> str:
    """The kernel times of one root's run, in the order they were printed."""
    times = []
    for ln in out.splitlines():
        if "] kernel: " in ln:
            m = re.search(r"kernel (\d+\.\d+) ms", ln)
            floor = re.search(r"replay floor of the smallest launch "
                              r"(\d+\.\d+) ms", ln)
            if m:
                shape = "served" if "served" in ln else "bench"
                kind = "f32" if "float32" in ln else "i16"
                b = re.search(r"B=(\d+)", ln).group(1)
                times.append(f"taat {shape} B={b} {kind} {m.group(1)} ms")
            elif floor:
                times.append(f"replay floor {floor.group(1)} ms")
        elif re.search(r"\] flash(_bwd)?: ", ln):
            times += [f"{name or 'fwd'} {ms} ms" for name, ms in
                      re.findall(r"(?:(dq|dkv) )?kernel (\d+\.\d+) ms", ln)]
    return ", ".join(times)


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--fwd-only"]
    mode = "fwd" if "--fwd-only" in sys.argv else "all"
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    for root in args:
        proc = subprocess.run([sys.executable, "-c", _CHILD, root, mode],
                              capture_output=True, text=True, timeout=600)
        out = proc.stdout + proc.stderr
        print(out, flush=True)
        if proc.returncode != 0:
            print(f"{root}: failed ({proc.returncode})", flush=True)
            return 1
        print(f"{root}: {summary(out)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

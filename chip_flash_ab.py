#!/usr/bin/env python3
"""Time the flash-attention kernels of one or more checkouts in turns, on
one NVIDIA card.

    python3 chip_flash_ab.py ROOT [ROOT ...] [--fwd-only]

Each ROOT is a checkout of this repository (for example the parent commit
unpacked with ``git archive`` beside the working tree). For each ROOT, in
the order given, a fresh process builds that checkout's kernels and runs
its own ``chip_smoke.py`` flash phases: the forward (``phase_flash``) and,
unless ``--fwd-only``, the dq and dkv kernels (``phase_flash_bwd``), each
held against its plain version and timed, on the synthetic rows of
``chip_smoke.py`` (3,072 tokens, one all-pad row) and on the rows of its
profiled training step. Give a root twice (A B B A) to see the spread.
One line per root summarises the kernel times; the phases' own lines are
printed above it. Needs the card; imports nothing of JAX.
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
import chip_smoke as cs
from mllm_sparse_retrieval_tpu_torch.configs import ModelFamily
from mllm_sparse_retrieval_tpu_torch.models import anyres, templates
from mllm_sparse_retrieval_tpu_torch.models.registry import get_family_spec
from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
    WordPieceLiteTokenizer)
cs.build_kernels()
# the prompt lengths chip_smoke.main computes, from the same draws
rng = np.random.default_rng(cs.SEED)
cs.phase_kernel_bench(rng)
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
        flash = "\n".join(ln for ln in out.splitlines()
                          if re.search(r"\] flash(_bwd)?: ", ln))
        times = re.findall(r"(?:(dq|dkv) )?kernel (\d+\.\d+) ms", flash)
        print(f"{root}: " + ", ".join(f"{name or 'fwd'} {ms} ms"
                                      for name, ms in times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build the impact index from encoded corpus jsonl shards.

Reads ``corpus_*.jsonl`` from the sparse output directory and writes the
packed + CSR index (``terms.json`` + ``index.npz``), with the native C++
builder unless ``--no-native``. Prints the index directory.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import torch

from mllm_sparse_retrieval_tpu_torch.cli.common import StepTimer, get_logger
from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input", required=True,
                        help="directory containing corpus_*.jsonl")
    parser.add_argument("--index", required=True,
                        help="output index directory")
    parser.add_argument("--no-native", action="store_true",
                        help="use the pure-Python builder")
    parser.add_argument("--device", default="cuda",
                        help="device of the scoring matrix --hbm-warm "
                             "places (default cuda)")
    parser.add_argument("--hbm-warm", action="store_true",
                        help="also place the scoring matrix in device memory "
                             "(the dtype and layout the auto search backend "
                             "uses) and report the placement time: the cost "
                             "each serving process pays at its first search")
    args = parser.parse_args(argv)

    logger = get_logger("index")
    timer = StepTimer(logger)
    timer.phase("build")
    paths = sorted(glob.glob(os.path.join(args.input, "corpus_*.jsonl")))
    if not paths:
        raise FileNotFoundError(f"no corpus_*.jsonl under {args.input}")
    t0 = time.time()
    index = ImpactIndex.from_jsonl(paths, use_native=not args.no_native,
                                   device=args.device)
    build_s = time.time() - t0
    timer.phase("save")
    index.save(args.index)
    timer.close()
    logger.info("metric index_build_seconds=%.2f docs=%d terms=%d",
                build_s, index.num_docs, index.num_terms)
    if args.hbm_warm:
        t0 = time.time()
        dev = index._search_plan("auto", 10)["dev"]
        if dev.is_cuda:
            torch.cuda.synchronize(dev.device)
        logger.info("metric hbm_placement_seconds=%.2f bytes=%d on %s "
                    "(CSR triples uploaded, scattered on the device)",
                    time.time() - t0, dev.numel() * dev.element_size(),
                    dev.device)
    logger.info("indexed %d docs, %d terms -> %s",
                index.num_docs, index.num_terms, args.index)
    print(args.index)


if __name__ == "__main__":
    main()

"""Search + evaluate: encode queries, search the indexes, fuse, print recall.

Dense only (``--passage-reps``), sparse only (``--sparse-index``), or
hybrid (both, fused with ``--alpha``: on the host, or on the device with
``--fusion-mode device``). Prints the recall summary (and ``--metrics``) of
each run; ``--eval-mode device`` computes them from target ranks on the
device and writes no run. The dense tier is the exact flat index in f32,
bf16 or int8 (``--dense-dtype``), or the ANN tier (``--ann-rank``); the
sparse results come back on the i32 or the compact48 wire
(``--impact-wire``).
"""

from __future__ import annotations

import argparse
import os

import torch

from mllm_sparse_retrieval_tpu_torch.cli.common import (
    Profiler, StepTimer, add_common_args, build_everything, get_logger,
    sparse_config_from_args)
from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc, SearchConfig
from mllm_sparse_retrieval_tpu_torch.index.ann import DenseANNIndex
from mllm_sparse_retrieval_tpu_torch.index.dense import DenseFlatIndex
from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex
from mllm_sparse_retrieval_tpu_torch.search.engine import run_search
from mllm_sparse_retrieval_tpu_torch.search.fusion import write_trec_run


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--passage-reps", default=None,
                        help="dense corpus dir (corpus_*.pkl)")
    parser.add_argument("--sparse-index", default=None,
                        help="impact index dir")
    parser.add_argument("--query-type", default="text",
                        choices=["text", "image"])
    parser.add_argument("--depth", type=int, default=1000)
    parser.add_argument("--alpha", type=float, default=0.5)
    parser.add_argument("--remove-query", action="store_true")
    parser.add_argument("--impact-backend", default="auto",
                        choices=["auto", "taat", "matmul"],
                        help="sparse scoring backend (auto = the TAAT CUDA "
                             "kernel on the card, the f32 matmul elsewhere)")
    parser.add_argument("--impact-wire", default="i32",
                        choices=["i32", "compact48"],
                        help="sparse result format: 'compact48' copies 6 "
                             "bytes per (score, id) pair instead of 8 "
                             "(integer weights only)")
    parser.add_argument("--fusion-mode", default="host",
                        choices=["host", "device"],
                        help="hybrid fusion route: 'host' = the "
                             "reference's run fusion in Python; 'device' = "
                             "the fused top-k on the device, one packed "
                             "copy per chunk (fusion run and recall only)")
    parser.add_argument("--fusion-rule", default="minmax",
                        choices=["minmax", "rrf"],
                        help="hybrid fusion formula: minmax = the "
                             "reference's weighted min-max sum; rrf = "
                             "Reciprocal Rank Fusion (host route only)")
    parser.add_argument("--ann-rank", type=int, default=0,
                        help="the ANN dense tier: width of the low-rank "
                             "prefilter (0 = exact flat search; final "
                             "scores stay exact, only the candidates are "
                             "approximate)")
    parser.add_argument("--ann-candidates", type=int, default=1024,
                        help="rescored candidates per query when "
                             "--ann-rank is set")
    parser.add_argument("--eval-mode", default="host",
                        choices=["host", "device"],
                        help="device: recall (and --metrics) from target "
                             "ranks computed on the device, one [B, 1+T] "
                             "copy per chunk instead of the run; no run is "
                             "written (incompatible with --save-dir)")
    parser.add_argument("--metrics", default="",
                        help="extra ranking metrics beyond recall, comma-"
                             "separated from {mrr,ndcg,map}")
    parser.add_argument("--dense-dtype", default="float32",
                        choices=["float32", "bfloat16", "int8"],
                        help="device dtype of the dense corpus matrix: "
                             "float32 (FAISS-flat parity) or bfloat16 (half "
                             "the bytes, f32 accumulation and scores) or "
                             "int8 (SQ8 scalar quantization: a quarter of "
                             "the bytes, exact int32 products, per-row and "
                             "per-query scales)")
    parser.add_argument("--save-dir", default=None,
                        help="write TREC run files here")
    parser.add_argument("--limit", type=int, default=0)
    args = parser.parse_args(argv)

    if args.ann_rank and args.dense_dtype == "int8":
        parser.error("--ann-rank is incompatible with --dense-dtype int8 "
                     "(pick ONE approximation; bf16 composes with ANN)")
    if args.fusion_rule == "rrf" and args.fusion_mode == "device":
        parser.error("--fusion-rule rrf is host-path only (the device-"
                     "fused program implements the min-max rule)")
    if args.passage_reps is None and args.sparse_index is None:
        parser.error("need --passage-reps and/or --sparse-index")
    if args.fusion_mode == "device" and (
            args.passage_reps is None or args.sparse_index is None):
        parser.error("--fusion-mode device needs both --passage-reps "
                     "and --sparse-index")
    if args.eval_mode == "device":
        if args.save_dir:
            parser.error("--eval-mode device never materializes runs; "
                         "drop --save-dir or use --eval-mode host")
        if args.passage_reps and args.sparse_index \
                and args.fusion_mode != "device":
            parser.error("--eval-mode device with both indexes needs "
                         "--fusion-mode device (host fusion materializes "
                         "the runs this mode avoids fetching)")

    logger = get_logger("search")
    timer = StepTimer(logger)
    timer.phase("setup")
    corpus, params, arch, tok, template, lora = build_everything(args)
    sparse_cfg = sparse_config_from_args(args)
    search_cfg = SearchConfig(
        passage_reps=args.passage_reps, sparse_index=args.sparse_index,
        depth=args.depth, alpha=args.alpha, remove_query=args.remove_query,
        query_type=args.query_type, batch_size=max(args.batch_size, 1))

    dense_index = impact_index = None
    if args.passage_reps:
        timer.phase("load dense index")
        dense_index = DenseFlatIndex.load(
            args.passage_reps, device=args.device,
            dtype={"bfloat16": torch.bfloat16, "int8": torch.int8}.get(
                args.dense_dtype, torch.float32))
        if args.ann_rank:
            dense_index = DenseANNIndex.from_flat(
                dense_index, rank=args.ann_rank,
                candidates=args.ann_candidates)
            logger.info("ANN tier: rank=%d candidates=%d (exact rescore)",
                        args.ann_rank, args.ann_candidates)
        logger.info("dense index: %d vectors", dense_index.size)
    if args.sparse_index:
        timer.phase("load sparse index")
        impact_index = ImpactIndex.load(args.sparse_index, device=args.device)
        logger.info("impact index: %d docs / %d terms",
                    impact_index.num_docs, impact_index.num_terms)

    mode = "full" if args.query_type == "text" else "single"
    queries = corpus.examples(mode)
    if args.limit:
        queries = queries[: args.limit]
    logger.info("searching %d %s queries on %s", len(queries),
                args.query_type, args.device)

    timer.phase("search")
    with Profiler(args.profile_dir):
        out = run_search(
            queries, params, arch, tok, template,
            query_type=args.query_type, sparse_cfg=sparse_cfg,
            search_cfg=search_cfg, dense_index=dense_index,
            impact_index=impact_index, reps_loc=RepsLoc(args.reps_loc),
            batch_size=args.batch_size, lora=lora,
            impact_backend=args.impact_backend,
            impact_wire=args.impact_wire,
            fusion_mode=args.fusion_mode, fusion_rule=args.fusion_rule,
            eval_mode=args.eval_mode,
            metrics=[m for m in args.metrics.split(",") if m],
            get_target=lambda qid: corpus.get_target(qid, args.query_type),
            device=args.device)
    timer.close()

    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        for name, run in (("dense", out.dense_run),
                          ("sparse", out.sparse_run),
                          ("fusion", out.fusion_run)):
            if run:
                write_trec_run(run, os.path.join(args.save_dir,
                                                 f"{name}.trec"), name)

    print(out.summary())


if __name__ == "__main__":
    main()

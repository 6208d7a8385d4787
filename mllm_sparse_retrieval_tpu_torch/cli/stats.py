"""Diagnostics CLI: term-weight histograms (``--mode term-weights``) and the
fusion-provenance rank analysis (``--mode provenance``) of
``eval/statistics.py``, with the JAX package's flags:

    python -m mllm_sparse_retrieval_tpu_torch.cli.stats --mode term-weights \\
        --dataset flickr --data-root DATA --family tiny_debug \\
        --num-images 50 --out-dir STATS [--device cpu]
    python -m mllm_sparse_retrieval_tpu_torch.cli.stats --mode provenance \\
        --passage-reps DENSE --sparse-index INDEX ...

Prints the summary and the PNG paths. The plots need matplotlib.
"""

from __future__ import annotations

import argparse

from mllm_sparse_retrieval_tpu_torch.cli.common import (
    StepTimer, add_common_args, build_everything, get_logger,
    sparse_config_from_args)
from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc, SearchConfig
from mllm_sparse_retrieval_tpu_torch.eval.statistics import (
    fusion_provenance_statistics, plot_provenance_stats,
    plot_term_weight_stats, term_weight_statistics)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--mode", default="term-weights",
                        choices=["term-weights", "provenance"])
    parser.add_argument("--num-images", type=int, default=50)
    parser.add_argument("--passage-reps", default=None)
    parser.add_argument("--sparse-index", default=None)
    parser.add_argument("--query-type", default="text",
                        choices=["text", "image"])
    parser.add_argument("--depth", type=int, default=1000)
    parser.add_argument("--alpha", type=float, default=0.5)
    parser.add_argument("--top-n", type=int, default=200)
    parser.add_argument("--out-dir", default="./stats_output")
    parser.add_argument("--limit", type=int, default=0)
    args = parser.parse_args(argv)

    logger = get_logger("stats")
    timer = StepTimer(logger)
    timer.phase("setup")
    corpus, params, arch, tok, template, lora = build_everything(args)
    sparse_cfg = sparse_config_from_args(args)

    if args.mode == "term-weights":
        timer.phase("encode+collect")
        stats = term_weight_statistics(
            corpus, params, arch, tok, template, sparse_cfg=sparse_cfg,
            num_images=args.num_images, batch_size=args.batch_size,
            lora=lora, device=args.device)
        logger.info(stats.summary())
        timer.phase("plot")
        paths = plot_term_weight_stats(stats, args.out_dir)
        timer.close()
        print(stats.summary())
        for p in paths:
            print(p)
        return

    # provenance mode: full hybrid search, then rank analysis
    if not (args.passage_reps and args.sparse_index):
        parser.error("provenance mode needs --passage-reps and --sparse-index")
    from mllm_sparse_retrieval_tpu_torch.index.dense import DenseFlatIndex
    from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex
    from mllm_sparse_retrieval_tpu_torch.search.engine import run_search

    timer.phase("load indexes")
    dense_index = DenseFlatIndex.load(args.passage_reps, device=args.device)
    impact_index = ImpactIndex.load(args.sparse_index, device=args.device)

    mode = "full" if args.query_type == "text" else "single"
    queries = corpus.examples(mode)
    if args.limit:
        queries = queries[: args.limit]

    timer.phase("search")
    out = run_search(
        queries, params, arch, tok, template,
        query_type=args.query_type, sparse_cfg=sparse_cfg,
        search_cfg=SearchConfig(depth=args.depth, alpha=args.alpha),
        dense_index=dense_index, impact_index=impact_index,
        reps_loc=RepsLoc(args.reps_loc), batch_size=args.batch_size,
        lora=lora, device=args.device)

    timer.phase("analyze")
    stats = fusion_provenance_statistics(out.dense_run, out.sparse_run,
                                         alpha=args.alpha, top_n=args.top_n)
    logger.info(stats.summary())
    path = plot_provenance_stats(stats, args.out_dir)
    timer.close()
    print(stats.summary())
    print(path)


if __name__ == "__main__":
    main()

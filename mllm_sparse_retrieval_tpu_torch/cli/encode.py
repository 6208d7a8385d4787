"""Encode the corpus (or queries) into dense + sparse artifacts.

Text encodes every caption (mode 'full'), image every unique image (mode
'single'); ``--query`` writes query.pkl / query.tsv instead of corpus
shards. Prints the dense and the sparse output directories.
"""

from __future__ import annotations

import argparse

from mllm_sparse_retrieval_tpu_torch.cli.common import (
    Profiler, StepTimer, add_common_args, build_everything, get_logger,
    sparse_config_from_args)
from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc
from mllm_sparse_retrieval_tpu_torch.pipelines.encode import (
    artifact_dir, encode_examples, write_artifacts)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--encode-type", default="text",
                        choices=["text", "image"])
    parser.add_argument("--query", action="store_true",
                        help="write query artifacts instead of corpus shards")
    parser.add_argument("--dense-output-dir", default="./dense_output")
    parser.add_argument("--sparse-output-dir", default="./sparse_output")
    parser.add_argument("--shard-index", type=int, default=0)
    parser.add_argument("--limit", type=int, default=0,
                        help="encode only the first N examples (0 = all)")
    args = parser.parse_args(argv)

    logger = get_logger("encode")
    timer = StepTimer(logger)
    timer.phase("setup")
    corpus, params, arch, tok, template, lora = build_everything(args)
    sparse_cfg = sparse_config_from_args(args)

    mode = "full" if args.encode_type == "text" else "single"
    examples = corpus.examples(mode)
    if args.limit:
        examples = examples[: args.limit]
    logger.info("encoding %d %s examples on %s", len(examples),
                args.encode_type, args.device)

    timer.phase("encode")
    with Profiler(args.profile_dir):
        result = encode_examples(
            examples, params, arch, tok, template,
            encode_type=args.encode_type, sparse_cfg=sparse_cfg,
            reps_loc=RepsLoc(args.reps_loc), batch_size=args.batch_size,
            is_query=args.query, lora=lora, device=args.device)

    timer.phase("write")
    model_name = args.family
    is_lora = args.lora_path is not None
    dense_dir = artifact_dir(args.dense_output_dir, model_name, args.dataset,
                             args.encode_type, sparse_cfg, lora=is_lora)
    sparse_dir = artifact_dir(args.sparse_output_dir, model_name,
                              args.dataset, args.encode_type, sparse_cfg,
                              lora=is_lora)
    write_artifacts(result, dense_dir, sparse_dir, is_query=args.query,
                    shard_index=args.shard_index)
    timer.close()
    logger.info("dense -> %s", dense_dir)
    logger.info("sparse -> %s", sparse_dir)
    print(dense_dir)
    print(sparse_dir)


if __name__ == "__main__":
    main()

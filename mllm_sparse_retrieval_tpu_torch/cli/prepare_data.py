"""Dataset preparation CLI: Karpathy JSON -> CSVs, few-shot subsets and
the captions-per-image check (``data/prep.py``), with the JAX package's
sub-commands and flags:

    python -m mllm_sparse_retrieval_tpu_torch.cli.prepare_data split \
        --json dataset.json --out-dir DATA/flickr --dataset flickr
    python -m mllm_sparse_retrieval_tpu_torch.cli.prepare_data few-shot \
        --train-csv DATA/flickr/flickr_train.csv \
        --out-csv DATA/flickr/flickr_train_200.csv --num-images 200
    python -m mllm_sparse_retrieval_tpu_torch.cli.prepare_data check \
        --csv DATA/flickr/flickr_test.csv
"""

from __future__ import annotations

import argparse

from mllm_sparse_retrieval_tpu_torch.data.prep import (
    check_captions_per_image, karpathy_json_to_csvs, sample_few_shot_csv)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_split = sub.add_parser("split", help="Karpathy dataset.json -> CSVs")
    p_split.add_argument("--json", required=True)
    p_split.add_argument("--out-dir", required=True)
    p_split.add_argument("--dataset", required=True,
                         choices=["coco", "flickr"])

    p_fs = sub.add_parser("few-shot", help="sample a few-shot train CSV")
    p_fs.add_argument("--train-csv", required=True)
    p_fs.add_argument("--out-csv", required=True)
    p_fs.add_argument("--num-images", type=int, required=True)
    p_fs.add_argument("--seed", type=int, default=0)

    p_chk = sub.add_parser("check", help="captions-per-image histogram")
    p_chk.add_argument("--csv", required=True)

    args = parser.parse_args(argv)
    if args.cmd == "split":
        out = karpathy_json_to_csvs(args.json, args.out_dir, args.dataset)
        for split, path in out.items():
            print(f"{split}\t{path}")
    elif args.cmd == "few-shot":
        n = sample_few_shot_csv(args.train_csv, args.out_csv,
                                args.num_images, args.seed)
        print(f"{args.out_csv}\t{n} rows")
    else:
        hist = check_captions_per_image(args.csv)
        for count in sorted(hist):
            print(f"{count} captions: {hist[count]} images")


if __name__ == "__main__":
    main()

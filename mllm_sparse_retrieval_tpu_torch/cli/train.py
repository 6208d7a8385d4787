"""Few-shot contrastive LoRA fine-tuning (the JAX package's ``cli/train.py``
on one device).

Trains LoRA adapters on a few-shot train split (``{dataset}_train_{N}.csv``
under ``--data-root``, as ``cli.prepare_data few-shot`` writes it) with the
batch symmetric InfoNCE, then writes the outputs the JAX CLI writes:
``lora.pkl`` (``models.lora.save_lora``), ``params.pkl`` with
``--train-full`` or ``--merge`` (the parameter tree as nested dicts and
lists of numpy arrays in the JAX layout; bf16 leaves as float32, since
numpy has no bfloat16), and ``ckpts/`` with ``--checkpoint-every``
(``ContrastiveTrainer.save_checkpoint``). Prints the adapter (or full
params) path.

    python -m mllm_sparse_retrieval_tpu_torch.cli.train --dataset flickr \\
        --data-root DATA --family tiny_debug --few-shot-sum 200 \\
        --batch-size 8 --num-epochs 5 --output-dir OUT [--device cpu]

``--mesh`` raises (sharding is ROADMAP Queue 1 #9); ``--fsdp`` and
``--no-zero1`` only set their ``TrainConfig`` fields, which act under a
mesh, as in the JAX CLI without one. ``--load-kbit`` raises (k-bit base
weights are Queue 1 #1). ``run(args, model=...)`` trains a model the
caller already holds, ``(params, arch, tokenizer, template)``.
"""

from __future__ import annotations

import argparse
import os
import pickle

import torch

from mllm_sparse_retrieval_tpu_torch.cli.common import (
    Profiler, StepTimer, add_common_args, get_logger, model_config_from_args)
from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc, TrainConfig
from mllm_sparse_retrieval_tpu_torch.data.karpathy import CrossModalCorpus
from mllm_sparse_retrieval_tpu_torch.models import build_model
from mllm_sparse_retrieval_tpu_torch.models import lora as lora_lib
from mllm_sparse_retrieval_tpu_torch.train.trainer import (
    ContrastiveTrainer, make_collator)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser)
    parser.add_argument("--few-shot-sum", type=int, default=200,
                        help="few-shot train CSV size")
    parser.add_argument("--learning-rate", type=float, default=5e-5)
    parser.add_argument("--num-epochs", type=int, default=5)
    parser.add_argument("--lr-schedule", default="linear",
                        choices=["linear", "cosine", "constant"],
                        help="linear decay (HF Trainer's default), warmup + "
                             "cosine decay to 0, or constant")
    parser.add_argument("--tau", type=float, default=0.05)
    parser.add_argument("--lora-rank", type=int, default=8)
    parser.add_argument("--lora-alpha", type=float, default=16)
    parser.add_argument("--lora-dropout", type=float, default=0.1,
                        help="dropout on the decoder's LoRA paths")
    parser.add_argument("--load-kbit", type=int, default=0, choices=[0, 4, 8],
                        help="k-bit base weights (QLoRA); not ported, "
                             "ROADMAP Queue 1 #1")
    parser.add_argument("--quant-format", default="nf4",
                        choices=["nf4", "linear"],
                        help="4-bit storage format of --load-kbit")
    parser.add_argument("--train-vision-lora", action="store_true")
    parser.add_argument("--train-projector-lora", action="store_true")
    parser.add_argument("--no-gather-gradient", action="store_true",
                        help="stop gradients through remote-shard negatives "
                             "(acts under a mesh)")
    parser.add_argument("--train-full", action="store_true",
                        help="full finetune (no LoRA)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute each decoder block in the backward "
                             "pass")
    parser.add_argument("--fsdp", action="store_true",
                        help="shard params over the data axis (acts under a "
                             "mesh)")
    parser.add_argument("--no-zero1", action="store_true",
                        help="replicate optimizer state (acts under a mesh)")
    parser.add_argument("--output-dir", default="./output")
    parser.add_argument("--log-every", type=int, default=10,
                        help="log every N steps; 0 disables periodic step "
                             "logging")
    parser.add_argument("--checkpoint-every", type=int, default=0)
    parser.add_argument("--merge", action="store_true",
                        help="also save merged encoder params")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--grad-accum-steps", type=int, default=1,
                        help="split each step batch into this many "
                             "micro-batches (negatives per micro-batch)")
    return parser


def run(args, model=None):
    """Train as the CLI does; ``model`` is ``(params, arch, tokenizer,
    template)`` on ``args.device``, else ``build_model`` makes it. Returns
    ``(path printed by the CLI, trainer)``."""
    if args.mesh:
        raise NotImplementedError(
            "--mesh: sharding is not ported (ROADMAP Queue 1 #9)")
    if args.load_kbit:
        raise NotImplementedError(
            f"--load-kbit {args.load_kbit}: k-bit base weights wait for "
            f"models/quantization.py (ROADMAP Queue 1 #1)")
    logger = get_logger("train")
    timer = StepTimer(logger)
    timer.phase("setup")
    corpus = CrossModalCorpus(args.dataset, "train", args.data_root,
                              few_shot_sum=args.few_shot_sum)
    if model is None:
        model = build_model(model_config_from_args(args),
                            captions=list(corpus.text_dict.values()),
                            device=args.device)
    params, arch, tok, template = model
    if tok is None:
        raise NotImplementedError(
            f"{args.checkpoint_path} has no tokenizer the port can load "
            f"(a tokenizer.json reader of its own is ROADMAP Queue 1 #8b)")
    examples = corpus.examples_single()   # one caption per image

    total_steps = ContrastiveTrainer.total_train_steps(
        len(examples), args.batch_size, args.num_epochs)
    tcfg = TrainConfig(
        learning_rate=args.learning_rate, num_epochs=args.num_epochs,
        lr_schedule=args.lr_schedule if total_steps > 0 else "constant",
        total_steps=total_steps,
        tau=args.tau, lora_rank=args.lora_rank, lora_alpha=args.lora_alpha,
        lora_dropout=args.lora_dropout, load_kbit=args.load_kbit,
        gather_save_gradient=not args.no_gather_gradient,
        train_vision_lora=args.train_vision_lora,
        train_projector_lora=args.train_projector_lora,
        shard_optimizer_state=not args.no_zero1,
        shard_params_data_axis=args.fsdp, train_full=args.train_full,
        remat=args.remat,
        output_dir=args.output_dir, seed=args.seed,
        checkpoint_every_steps=args.checkpoint_every,
        grad_accum_steps=args.grad_accum_steps)

    if args.train_full:
        adapters = None
        logger.info("full finetune on %s", args.device)
    else:
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        adapters = lora_lib.init_lora(
            gen, params, arch, rank=tcfg.lora_rank, alpha=tcfg.lora_alpha,
            train_vision=tcfg.train_vision_lora,
            train_projector=tcfg.train_projector_lora, device=args.device)
        logger.info("LoRA params: %d", lora_lib.num_lora_params(adapters))

    trainer = ContrastiveTrainer(params, arch, adapters, tcfg,
                                 reps_loc=RepsLoc(args.reps_loc),
                                 device=args.device)
    collate = make_collator(tok, template, arch)

    timer.phase("train")
    with Profiler(args.profile_dir):
        trainer.train(examples, collate, batch_size=args.batch_size,
                      num_epochs=args.num_epochs, log_every=args.log_every,
                      logger=lambda m: logger.info(m),
                      checkpoint_dir=os.path.join(args.output_dir, "ckpts")
                      if args.checkpoint_every else None,
                      seed=args.seed)

    timer.phase("save")
    os.makedirs(args.output_dir, exist_ok=True)
    if args.train_full:
        out_path = os.path.join(args.output_dir, "params.pkl")
        with open(out_path, "wb") as f:
            pickle.dump(lora_lib.to_numpy(trainer.params), f)
        logger.info("full params -> %s", out_path)
    else:
        out_path = os.path.join(args.output_dir, "lora.pkl")
        lora_lib.save_lora(trainer.adapters, out_path)
        logger.info("adapters -> %s", out_path)
        if args.merge:
            merged = trainer.merged_params()
            with open(os.path.join(args.output_dir, "params.pkl"), "wb") as f:
                pickle.dump(lora_lib.to_numpy(merged), f)
            logger.info("merged params -> %s/params.pkl", args.output_dir)
    timer.close()
    return out_path, trainer


def main(argv=None):
    out_path, _ = run(build_parser().parse_args(argv))
    print(out_path)


if __name__ == "__main__":
    main()

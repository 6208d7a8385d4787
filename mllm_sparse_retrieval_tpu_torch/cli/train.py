"""Few-shot contrastive LoRA fine-tuning (the JAX package's
``cli/train.py``).

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

``--load-kbit {4,8}`` trains QLoRA-style: the base is quantized on its
device before training (``models.quantization.quantize_params``: nf4 or
linear int4 at 4 bits, ``--quant-format``; linear int8 at 8), dequantized
per use, and only the adapters train; with ``--train-full`` or ``--merge``
it is a usage error, as in the JAX CLI. ``--mesh`` trains over
``cli.common.mesh_from_args``' mesh (every card for a CUDA ``--device``,
``--model-parallel`` the model axis; ``--device cpu`` a 1x1 mesh of the
CPU): the global-batch loss over the data shards, ZeRO-1 optimizer state
unless ``--no-zero1``, FSDP parameters with ``--train-full --fsdp``,
``--no-gather-gradient`` for the sharded loss (``train/trainer.py``).
Without a mesh those three flags only set their ``TrainConfig`` fields, as
in the JAX CLI. Under a launch of several processes (``WORLD_SIZE`` > 1,
as ``torchrun`` sets it with ``MASTER_ADDR``, ``MASTER_PORT`` and ``RANK``)
``--mesh`` joins the process group (``parallel.multihost``: ``nccl`` for a
CUDA ``--device``, ``gloo`` for the CPU) and trains a data axis across the
processes, each on its own cards; a missing launcher variable raises
``ValueError`` rather than train alone. Only the primary process writes
the outputs and prints the path. ``run(args, model=...)`` trains a model
the caller already holds, ``(params, arch, tokenizer, template)``.

    torchrun --nproc-per-node 2 -m mllm_sparse_retrieval_tpu_torch.cli.train \\
        --mesh ... [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import pickle

import torch

from mllm_sparse_retrieval_tpu_torch.cli.common import (
    Profiler, StepTimer, add_common_args, get_logger, mesh_from_args,
    model_config_from_args)
from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc, TrainConfig
from mllm_sparse_retrieval_tpu_torch.data.karpathy import CrossModalCorpus
from mllm_sparse_retrieval_tpu_torch.models import build_model
from mllm_sparse_retrieval_tpu_torch.models import lora as lora_lib
from mllm_sparse_retrieval_tpu_torch.models.quantization import (
    quantize_params, quantized_bytes)
from mllm_sparse_retrieval_tpu_torch.parallel import multihost
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
                        help="store base weights quantized, dequantized per "
                             "use (QLoRA)")
    parser.add_argument("--quant-format", default="nf4",
                        choices=["nf4", "linear"],
                        help="4-bit storage format: nf4 (blockwise "
                             "NormalFloat + double-quant scales) or linear "
                             "per-channel int4; 8-bit is always linear")
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
    if args.mesh and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK")
                   if not os.environ.get(k)]
        if missing:
            raise ValueError(
                f"--mesh under WORLD_SIZE={os.environ['WORLD_SIZE']} needs "
                f"the launcher's {', '.join(missing)} to join the other "
                f"processes")
        multihost.initialize_multihost(device=args.device)
    if args.load_kbit:
        if args.train_full:
            build_parser().error("--load-kbit pairs with LoRA (QLoRA); "
                                 "--train-full needs trainable fp weights")
        if args.merge:
            build_parser().error("--merge cannot fold adapters into a "
                                 "quantized base; serve adapters "
                                 "separately (--lora-path)")
    logger = get_logger("train")
    timer = StepTimer(logger)
    timer.phase("setup")
    mesh = mesh_from_args(args)
    corpus = CrossModalCorpus(args.dataset, "train", args.data_root,
                              few_shot_sum=args.few_shot_sum)
    if model is None:
        model = build_model(model_config_from_args(args),
                            captions=list(corpus.text_dict.values()),
                            device=args.device)
    params, arch, tok, template = model
    if tok is None:
        raise NotImplementedError(
            f"{args.checkpoint_path} has no tokenizer: the port reads the "
            f"checkpoint's tokenizer.json, or its sentencepiece "
            f"tokenizer.model")
    if args.load_kbit:
        fp_bytes = quantized_bytes(params)
        mode = args.quant_format if args.load_kbit == 4 else "linear"
        params = quantize_params(params, bits=args.load_kbit, mode=mode)
        logger.info("kbit load: %d-bit (%s) base, %.1f MB -> %.1f MB (%.2fx)",
                    args.load_kbit, mode, fp_bytes / 1e6,
                    quantized_bytes(params) / 1e6,
                    fp_bytes / max(quantized_bytes(params), 1))
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
        logger.info("full finetune on %s (%s)", args.device,
                    "FSDP param sharding" if args.fsdp and mesh is not None
                    else "whole params")
    else:
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        adapters = lora_lib.init_lora(
            gen, params, arch, rank=tcfg.lora_rank, alpha=tcfg.lora_alpha,
            train_vision=tcfg.train_vision_lora,
            train_projector=tcfg.train_projector_lora, device=args.device)
        logger.info("LoRA params: %d", lora_lib.num_lora_params(adapters))

    trainer = ContrastiveTrainer(params, arch, adapters, tcfg, mesh=mesh,
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
    # every process gathers what is split over the processes; the primary
    # one writes
    write = multihost.is_primary_host()
    if write:
        os.makedirs(args.output_dir, exist_ok=True)
    if args.train_full:
        out_path = os.path.join(args.output_dir, "params.pkl")
        merged = lora_lib.to_numpy(trainer.merged_params())
        if write:
            with open(out_path, "wb") as f:
                pickle.dump(merged, f)
            logger.info("full params -> %s", out_path)
    else:
        out_path = os.path.join(args.output_dir, "lora.pkl")
        if write:
            lora_lib.save_lora(trainer.adapters, out_path)
            logger.info("adapters -> %s", out_path)
        if args.merge:
            merged = lora_lib.to_numpy(trainer.merged_params())
            if write:
                with open(os.path.join(args.output_dir, "params.pkl"),
                          "wb") as f:
                    pickle.dump(merged, f)
                logger.info("merged params -> %s/params.pkl",
                            args.output_dir)
    timer.close()
    return out_path, trainer


def main(argv=None):
    out_path, _ = run(build_parser().parse_args(argv))
    if multihost.is_primary_host():
        print(out_path)


if __name__ == "__main__":
    main()

"""Shared CLI plumbing: argument parsing into the config dataclasses,
model and corpus construction, logging, step timing and an optional
``torch.profiler`` trace."""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Optional

import torch

from mllm_sparse_retrieval_tpu_torch.configs import (
    ModelConfig, ModelFamily, RepsLoc, SparseConfig)
from mllm_sparse_retrieval_tpu_torch.data.karpathy import CrossModalCorpus
from mllm_sparse_retrieval_tpu_torch.models import build_model
from mllm_sparse_retrieval_tpu_torch.models.lora import load_lora
from mllm_sparse_retrieval_tpu_torch.parallel.mesh import make_mesh


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


class StepTimer:
    """Per-phase wall-clock accounting, logged as each phase ends."""

    def __init__(self, logger: logging.Logger):
        self.logger = logger
        self.marks = []
        self._t0 = time.time()
        self._label = None

    def phase(self, label: str) -> None:
        now = time.time()
        if self._label is not None:
            self.marks.append((self._label, now - self._t0))
            self.logger.info("phase %-24s %.2fs", self._label, now - self._t0)
        self._label = label
        self._t0 = now

    def close(self) -> None:
        self.phase("__end__")
        self._label = None


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", default="flickr", choices=["coco", "flickr"])
    p.add_argument("--data-root", default="/root/reference/data")
    p.add_argument("--split", default="test")
    p.add_argument("--family", default="tiny_debug",
                   choices=[f.value for f in ModelFamily])
    p.add_argument("--checkpoint-path", default=None,
                   help="converted checkpoint directory (models/convert.py) "
                        "of a real family")
    p.add_argument("--lora-path", default=None)
    p.add_argument("--reps-loc", default="before_pad",
                   choices=["before_pad", "after_pad"])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--mesh", action="store_true",
                   help="shard work over every local card (cuda) or over "
                        "--device alone (cpu)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="model-axis size of --mesh")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model and indexes (default "
                        "cuda; cpu runs the plain versions of the kernels)")
    # sparse knobs (reference PromptRepsLLMDataArguments)
    p.add_argument("--sparse-length", type=int, default=128)
    p.add_argument("--sparse-manual", action="store_true")
    p.add_argument("--no-filter", action="store_true",
                   help="disable leading-char token filtering")
    p.add_argument("--num-expanded-tokens", type=int, default=0)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace here")


def sparse_config_from_args(args) -> SparseConfig:
    return SparseConfig(
        sparse_length=args.sparse_length,
        sparse_manual=args.sparse_manual,
        is_filtered=not args.no_filter,
        num_expanded_tokens=args.num_expanded_tokens,
    )


def model_config_from_args(args) -> ModelConfig:
    """The model's config from the arguments, as the JAX CLIs build it:
    ``build_everything`` loads the adapter from its ``lora_path``, and
    ``config_to_json`` writes both restored fields into a pipeline JSON."""
    return ModelConfig(family=ModelFamily(args.family),
                       checkpoint_path=args.checkpoint_path,
                       lora_path=args.lora_path,
                       reps_loc=RepsLoc(args.reps_loc), dtype=args.dtype)


def mesh_from_args(args):
    """``make_mesh(model_parallel=args.model_parallel)`` under ``--mesh``
    (every card for a CUDA ``--device``, else that device alone), else
    None."""
    if not args.mesh:
        return None
    devices = None if torch.device(args.device).type == "cuda" \
        else [args.device]
    return make_mesh(model_parallel=args.model_parallel, devices=devices)


def build_everything(args):
    """``(corpus, params, arch, tokenizer, template, mesh, lora)`` on
    ``args.device`` (``mesh`` None without ``--mesh``, see
    ``mesh_from_args``). Raises ``NotImplementedError`` for a checkpoint
    without a tokenizer file (``tokenizer.json`` or ``tokenizer.model``)."""
    mesh = mesh_from_args(args)
    corpus = CrossModalCorpus(args.dataset, args.split, args.data_root)
    cfg = model_config_from_args(args)
    params, arch, tok, template = build_model(
        cfg, captions=list(corpus.text_dict.values()), device=args.device)
    if tok is None:
        raise NotImplementedError(
            f"{args.checkpoint_path} has no tokenizer: the port reads the "
            f"checkpoint's tokenizer.json, or its sentencepiece "
            f"tokenizer.model")
    lora = load_lora(cfg.lora_path, args.device) if cfg.lora_path else None
    return corpus, params, arch, tok, template, mesh, lora


class Profiler:
    """Optional ``torch.profiler`` trace around the hot loop, written to
    ``<trace_dir>/trace.json`` (Chrome trace format)."""

    def __init__(self, trace_dir: Optional[str]):
        self.trace_dir = trace_dir
        self._prof = None

    def __enter__(self):
        if self.trace_dir:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(self.trace_dir, "trace.json"))
            self._prof = None
        return False

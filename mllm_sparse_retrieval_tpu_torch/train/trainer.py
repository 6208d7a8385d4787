"""Contrastive LoRA trainer on one device (the JAX package's
``train/trainer.py`` without a mesh).

- Base params are frozen (``requires_grad=False``); the LoRA adapters are
  the trainable tree, every leaf of it (``a``, ``b`` and ``scale``, as the
  JAX trainer differentiates every leaf). ``adapters=None`` or
  ``cfg.train_full`` trains the full param tree instead.
- One step: the text and image towers through ``models.api.encode_any``
  (the image prompts of LLaVA-NeXT's anyres and InternVL2.5's dynamic
  tiling reach ``FLASH_MIN_SEQ`` and take the flash kernels, forward and
  backward; Qwen2.5-VL image prompts carry ``[3, B, T]`` M-RoPE ids), the
  batch symmetric InfoNCE (``train/contrastive.py``),
  ``torch.autograd.grad`` over the trainable leaves, then the update the
  JAX trainer's optax chain makes, written out: global-norm clipping
  (scale by ``max_norm / norm`` only when ``norm >= max_norm``), Adam
  (``m_hat / (sqrt(v_hat) + 1e-8)``) or AdamW (``+ weight_decay * param``
  before the learning rate), and the learning rate of the schedule at the
  update count before the step. The trainable tensors are updated in place.
- Gradient accumulation splits the step batch into micro-batches (in-batch
  negatives come from the micro-batch; M-RoPE ids split on their batch
  axis), sums their f32 gradients, divides by the count, casts them to the
  trainable dtype and reports the mean loss. Pixels given as a dict (the
  anyres and the Qwen native-resolution layouts) cannot be split, as the
  JAX trainer's reshape cannot split them: that raises.
- LoRA dropout draws from seeds derived from ``(cfg.seed, step)``
  (``layers.fold_seed``), so a resumed run replays exactly; with
  ``cfg.remat`` every decoder block is recomputed in the backward pass.
- Checkpoints keep the JAX layout, ``<dir>/step_<n>/`` and a ``latest``
  file, written with ``torch.save`` (the JAX trainer uses Orbax).

Not ported: meshes (ROADMAP Queue 1 #9, sharding) and ``load_kbit``
(``models/quantization.py``, Queue 1 #1); both raise.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc, TrainConfig
from mllm_sparse_retrieval_tpu_torch.data.karpathy import Example
from mllm_sparse_retrieval_tpu_torch.models import layers as L
from mllm_sparse_retrieval_tpu_torch.models import lora as lora_lib
from mllm_sparse_retrieval_tpu_torch.models.api import (
    encode_any, image_input_spec, mrope_ids_for_batch)
from mllm_sparse_retrieval_tpu_torch.models.layers import FLASH_MIN_SEQ
from mllm_sparse_retrieval_tpu_torch.pipelines.encode import (
    default_pixel_loader, default_raw_image_loader)
from mllm_sparse_retrieval_tpu_torch.train.contrastive import info_nce_loss

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8     # optax.adam defaults
CHECKPOINT_FILE = "checkpoint.pt"


@dataclass
class TrainBatch:
    text_ids: np.ndarray      # [B, Tt]
    text_mask: np.ndarray     # [B, Tt]
    image_ids: np.ndarray     # [B, Ti]
    image_mask: np.ndarray    # [B, Ti]
    # [B, H, W, 3] (LLaVA), [B, tiles, S, S, 3] (InternVL), [B, S, pd]
    # (Qwen, fixed grid), or a dict of arrays (anyres, Qwen native)
    pixels: Any
    image_pos_ids: Optional[np.ndarray] = None  # [3, B, Ti] M-RoPE (Qwen)


def make_collator(tokenizer, template, arch,
                  pixel_loader: Optional[Callable] = None,
                  seq_pad_multiple: int = 16):
    """Host collator: examples -> ``TrainBatch`` of numpy arrays.

    ``pixel_loader(example)`` returns the example's image: a raw ``[H, W,
    3]`` float array in [0, 1] for the variable families, the model's
    pixel input for the fixed-grid ones. By default the synthetic loaders of
    ``pipelines/encode.py`` (the port decodes no image file). The image
    prompts of the variable families (anyres, InternVL's tiles, Qwen's
    native resolution) are padded to the family's longest prompt, rounded
    up to a multiple of 512 once it reaches ``FLASH_MIN_SEQ``, so that the
    decoder takes the flash kernels (3,072 tokens on LLaVA-NeXT, 3,584 on
    InternVL2.5). Qwen2.5-VL image prompts get ``image_pos_ids``: from each
    example's own grid at native resolution, from the fixed grid
    otherwise."""
    spec = image_input_spec(arch)
    if spec.variable:
        if pixel_loader is None:
            pixel_loader = default_raw_image_loader()
        base_prompt = template.image_prompt()
        img_fixed_len = len(tokenizer.encode(template.expand_image(
            base_prompt, spec.max_image_tokens)))
        if img_fixed_len >= FLASH_MIN_SEQ:
            img_fixed_len = -(-img_fixed_len // 512) * 512
    else:
        if pixel_loader is None:
            raw_loader = default_pixel_loader(spec.image_size)
            pixel_loader = lambda e: spec.preprocess(raw_loader(e))  # noqa: E731
        img_prompt = template.expand_image(template.image_prompt(),
                                           spec.num_image_tokens)

    def collate(batch: Sequence[Example], text_max_len: Optional[int] = None
                ) -> TrainBatch:
        text_rows = [
            tokenizer.encode(template.fill_text(template.text_prompt(), e.text))
            for e in batch]
        t_ids, t_mask = tokenizer.pad_batch(
            text_rows, max_len=text_max_len, pad_to_multiple=seq_pad_multiple)
        if spec.variable:
            vitems = [spec.preprocess_example(pixel_loader(e)) for e in batch]
            img_rows = [tokenizer.encode(template.expand_image(base_prompt, n))
                        for _, n in vitems]
            i_ids, i_mask = tokenizer.pad_batch(
                img_rows, max_len=img_fixed_len,
                pad_to_multiple=seq_pad_multiple)
            pixels = spec.batch_vision([item for item, _ in vitems])
            pos = spec.mrope_from_batch(i_ids, i_mask, pixels) \
                if spec.mrope_from_batch else None
        else:
            img_rows = [tokenizer.encode(img_prompt)] * len(batch)
            i_ids, i_mask = tokenizer.pad_batch(
                img_rows, pad_to_multiple=seq_pad_multiple)
            pixels = np.stack([pixel_loader(e) for e in batch])
            pos = mrope_ids_for_batch(arch, i_ids, i_mask) \
                if spec.needs_mrope else None
        return TrainBatch(t_ids, t_mask, i_ids, i_mask, pixels, pos)

    return collate


def _map(fn, tree: Any):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """``optax.linear_schedule(init, end, steps)`` at ``count``."""
    if steps <= 0:
        return init
    c = min(max(count, 0), steps)
    return (init - end) * (1 - c / steps) + end


class ContrastiveTrainer:
    """LoRA-only (or full) contrastive fine-tuning on one device."""

    @staticmethod
    def total_train_steps(n_examples: int, batch_size: int,
                          num_epochs: int) -> int:
        """Step count of ``train()``'s loop (drop-last batching): the value
        to put in ``TrainConfig.total_steps`` for the linear schedule."""
        per_epoch = max((n_examples - batch_size) // batch_size + 1, 0) \
            if n_examples >= batch_size else 0
        return per_epoch * num_epochs

    def __init__(self, params: Dict, arch, adapters: Optional[Dict],
                 cfg: TrainConfig, mesh=None,
                 reps_loc: RepsLoc = RepsLoc.BEFORE_PAD, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "the port trains on one device: meshes wait for sharding "
                "(ROADMAP Queue 1 #9, parallel/*)")
        if cfg.load_kbit:
            raise NotImplementedError(
                f"load_kbit={cfg.load_kbit}: k-bit base weights wait for "
                f"models/quantization.py (ROADMAP Queue 1 #1)")
        if cfg.lr_schedule not in ("linear", "cosine", "constant"):
            raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}: "
                             "'linear', 'cosine', or 'constant'")
        if cfg.lr_schedule in ("linear", "cosine") and cfg.total_steps <= 0:
            raise ValueError(f"lr_schedule={cfg.lr_schedule!r} needs "
                             f"total_steps")
        self.params = params
        self.arch = arch
        self.cfg = cfg
        self.reps_loc = reps_loc
        self.device = torch.device(device)
        self.full_finetune = cfg.train_full or adapters is None
        self.adapters = None if self.full_finetune else adapters
        self.step = 0
        self.loss_history: List[float] = []
        for x in lora_lib.tree_leaves(params):
            x.requires_grad_(self.full_finetune and x.is_floating_point())
        leaves = self._trainable_leaves()
        for x in leaves:
            x.requires_grad_(True)
        self.opt_state = {
            "count": 0,
            "mu": [torch.zeros_like(x, requires_grad=False) for x in leaves],
            "nu": [torch.zeros_like(x, requires_grad=False) for x in leaves]}

    def _trainable(self):
        return self.params if self.full_finetune else self.adapters

    def _trainable_leaves(self) -> List[torch.Tensor]:
        return [x for x in lora_lib.tree_leaves(self._trainable())
                if x.is_floating_point()]

    def learning_rate(self, count: int) -> float:
        """The schedule at update count ``count`` (0 for the first step), as
        the JAX trainer's optax schedules give it."""
        cfg = self.cfg
        lr, warm = cfg.learning_rate, cfg.warmup_steps
        if cfg.lr_schedule == "linear":
            if warm > 0 and count < warm:
                return _linear(0.0, lr, warm, count)
            decay = max(cfg.total_steps - warm, 1)
            return _linear(lr, 0.0, decay, count - warm if warm > 0
                           else count)
        if cfg.lr_schedule == "cosine":
            if count < warm:
                return _linear(0.0, lr, warm, count)
            steps = max(cfg.total_steps, warm + 1) - warm
            c = min(count - warm, steps)
            return lr * 0.5 * (1 + math.cos(math.pi * c / steps))
        return _linear(0.0, lr, warm, count) if warm > 0 else lr

    # ---- one step ------------------------------------------------------------

    def _to_device(self, batch: TrainBatch, lo: int, hi: int):
        def put(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a[lo:hi]))
            return t.to(self.device, dtype)

        pixels = batch.pixels
        if isinstance(pixels, dict):
            pixels = {k: put(v) for k, v in pixels.items()}
        else:
            pixels = put(pixels)
        pos = batch.image_pos_ids
        if pos is not None:          # [3, B, T]: the batch axis is the 2nd
            pos = torch.from_numpy(np.ascontiguousarray(
                pos[:, lo:hi])).to(self.device, torch.long)
        return (put(batch.text_ids, torch.long), put(batch.text_mask),
                put(batch.image_ids, torch.long), put(batch.image_mask),
                pixels, pos)

    def _loss(self, t_ids, t_mask, i_ids, i_mask, pixels, pos,
              seed: int) -> torch.Tensor:
        cfg = self.cfg
        dropout = 0.0 if self.full_finetune else cfg.lora_dropout
        t_seed = i_seed = None
        if dropout > 0.0:
            t_seed, i_seed = L.fold_seed(seed, 0), L.fold_seed(seed, 1)
        _, t_emb = encode_any(self.params, self.arch, t_ids, t_mask, None,
                              self.reps_loc, self.adapters, remat=cfg.remat,
                              lora_seed=t_seed, lora_dropout=dropout)
        _, i_emb = encode_any(self.params, self.arch, i_ids, i_mask, pixels,
                              self.reps_loc, self.adapters,
                              position_ids=pos, remat=cfg.remat,
                              lora_seed=i_seed, lora_dropout=dropout)
        return info_nce_loss(t_emb, i_emb, cfg.tau)

    def train_on_batch(self, batch: TrainBatch) -> float:
        """One optimizer step on a collated batch; returns the loss."""
        accum = max(int(self.cfg.grad_accum_steps), 1)
        b = batch.text_ids.shape[0]
        if b % accum != 0:
            raise ValueError(f"batch size {b} not divisible by "
                             f"grad_accum_steps {accum}")
        if accum > 1 and isinstance(batch.pixels, dict):
            # the JAX trainer reshapes the pixels as one array here, which
            # a dict has no method for
            raise AttributeError(
                f"grad_accum_steps={accum} splits pixels as one array; "
                f"this family's pixels are a dict of "
                f"{sorted(batch.pixels)}")
        m = b // accum
        leaves = self._trainable_leaves()
        step_seed = L.fold_seed(self.cfg.seed, self.step)
        total = loss_sum = None
        for i in range(accum):
            seed = step_seed if accum == 1 else L.fold_seed(step_seed, i)
            loss = self._loss(*self._to_device(batch, i * m, (i + 1) * m),
                              seed)
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
            g = [torch.zeros_like(x) if gi is None else gi
                 for x, gi in zip(leaves, g)]
            if accum == 1:
                grads, loss_sum = g, loss.detach()
            elif total is None:
                total, loss_sum = [gi.float() for gi in g], loss.detach()
            else:
                total = [a + gi.float() for a, gi in zip(total, g)]
                loss_sum = loss_sum + loss.detach()
        if accum > 1:
            # f32 sums over the micro-batches, averaged, in the leaves' dtype
            grads = [(a / accum).to(x.dtype) for a, x in zip(total, leaves)]
            loss_sum = loss_sum / accum
        self._update(leaves, grads)
        self.step += 1
        loss = float(loss_sum)
        self.loss_history.append(loss)
        return loss

    @torch.no_grad()
    def _update(self, leaves, grads) -> None:
        cfg = self.cfg
        st = self.opt_state
        max_norm = cfg.max_grad_norm
        if max_norm and max_norm > 0:
            norm = sum((g * g).sum() for g in grads).sqrt()
            keep = norm < max_norm
            grads = [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
                     for g in grads]
        lr = self.learning_rate(st["count"])
        count = st["count"] + 1
        c1, c2 = 1 - ADAM_B1 ** count, 1 - ADAM_B2 ** count
        for x, g, mu, nu in zip(leaves, grads, st["mu"], st["nu"]):
            mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
            nu.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * nu)
            u = (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)
            if cfg.weight_decay > 0:
                u = u + cfg.weight_decay * x
            x.add_((u * -lr).to(x.dtype))
        st["count"] = count

    # ---- epochs, merge -------------------------------------------------------

    def train(self, examples: Sequence[Example], collate: Callable,
              batch_size: int, num_epochs: Optional[int] = None,
              log_every: int = 1,
              logger: Optional[Callable[[str], None]] = print,
              checkpoint_dir: Optional[str] = None,
              text_max_len: Optional[int] = None, seed: int = 0
              ) -> List[float]:
        """Epoch loop with per-epoch shuffling (``np.random.default_rng
        (seed)``) and drop-last batching, as the JAX trainer runs it."""
        num_epochs = num_epochs or self.cfg.num_epochs
        rng = np.random.default_rng(seed)
        order = np.arange(len(examples))
        every = self.cfg.checkpoint_every_steps
        for epoch in range(num_epochs):
            rng.shuffle(order)
            for start in range(0, len(examples) - batch_size + 1,
                               batch_size):
                batch_ex = [examples[i]
                            for i in order[start:start + batch_size]]
                loss = self.train_on_batch(collate(batch_ex, text_max_len))
                if logger and log_every and self.step % log_every == 0:
                    logger(f"epoch {epoch} step {self.step} loss {loss:.4f}")
                if checkpoint_dir and every and self.step % every == 0:
                    self.save_checkpoint(checkpoint_dir)
        if checkpoint_dir:
            self.save_checkpoint(checkpoint_dir)
        return self.loss_history

    def merged_params(self) -> Dict:
        """Fold trained adapters into the base params (inference form)."""
        if self.full_finetune:
            return self.params
        return lora_lib.merge_lora(self.params, self.adapters)

    # ---- checkpoints ---------------------------------------------------------

    def save_checkpoint(self, directory: str) -> None:
        """``<directory>/step_<n>/checkpoint.pt`` (the trainable tree and the
        optimizer state) and ``<directory>/latest``."""
        path = os.path.join(directory, f"step_{self.step}")
        os.makedirs(path, exist_ok=True)
        cpu = (lambda x: x.detach().cpu())
        st = self.opt_state
        torch.save({"adapters": _map(cpu, self._trainable()),
                    "opt_state": {"count": st["count"],
                                  "mu": [cpu(x) for x in st["mu"]],
                                  "nu": [cpu(x) for x in st["nu"]]}},
                   os.path.join(path, CHECKPOINT_FILE))
        with open(os.path.join(directory, "latest"), "w") as f:
            f.write(str(self.step))

    @torch.no_grad()
    def restore_checkpoint(self, directory: str,
                           step: Optional[int] = None) -> int:
        """Load ``step`` (default: ``latest``) into this trainer's trainable
        tensors and optimizer state, in place; returns the step."""
        if step is None:
            with open(os.path.join(directory, "latest")) as f:
                step = int(f.read().strip())
        saved = torch.load(
            os.path.join(directory, f"step_{step}", CHECKPOINT_FILE),
            map_location=self.device, weights_only=True)
        mine = lora_lib.tree_leaves(self._trainable())
        theirs = lora_lib.tree_leaves(saved["adapters"])
        if [tuple(x.shape) for x in mine] != [tuple(x.shape) for x in theirs]:
            raise ValueError(f"checkpoint at step {step} does not match the "
                             f"trainable tree")
        for x, y in zip(mine, theirs):
            x.copy_(y)
        st = self.opt_state
        st["count"] = int(saved["opt_state"]["count"])
        for key in ("mu", "nu"):
            for x, y in zip(st[key], saved["opt_state"][key]):
                x.copy_(y)
        self.step = step
        return step

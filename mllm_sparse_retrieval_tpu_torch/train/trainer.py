"""Contrastive LoRA trainer on one device or over a mesh (the JAX
package's ``train/trainer.py``).

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
- Asynchronous steps, as the JAX trainer runs them:
  ``train_on_batch(batch, blocking=False)`` returns the loss as a detached
  0-d tensor on the trainer's device and leaves the step queued on the
  card. On CUDA the batch goes up from pinned host memory with
  ``non_blocking=True``, and nothing else in a step on one process waits
  for the card either. ``train()`` blocks only on the steps that log or
  checkpoint, and on every ``sync_stride``-th step otherwise
  (``SYNC_BUDGET_BYTES`` over the bytes of the trainable leaves and their
  Adam moments, clamped to 1..32), which bounds the pinned batches held
  by steps in flight. Its ``loss_history`` is floats on return, also when
  a step raises (an element that cannot be read becomes NaN, and the
  step's own exception propagates). The host syncs are ``_retire`` (a
  blocking step's loss) and ``_drain`` (the stride); steps over processes
  (gloo collectives) and the MoE FFN's dispatch (a boolean-mask index)
  sync besides.

- QLoRA: ``params`` may hold ``QuantizedWeight``s (``models/quantization.
  quantize_params``, ``cfg.load_kbit``); they are dequantized per use and
  never reach the optimizer, which updates the adapters only. A full
  finetune over a quantized tree raises ``ValueError``, as in the JAX
  package.

- Over a ``parallel.mesh.Mesh`` (one process, as the JAX package's
  single controller): each data shard runs its rows of the batch on
  ``mesh.shard_devices[i]``, its decoder's flash kernels once per device
  of its row (``allow_flash=mesh.row(i)``: the heads split over the model
  axis). The trainable leaves live once on ``mesh.lead`` and each shard
  reads them through ``.to(device)``: the same tensor on a repeated
  device, a differentiable copy on another card, so autograd sums the
  shards' gradients onto the lead leaves (the JAX program's all-reduce).
  The loss is ``info_nce_loss`` of the gathered global batch, or with
  ``gather_save_gradient=False`` ``sharded_info_nce_loss`` (gradients
  only through each shard's own rows). LoRA dropout draws each shard's
  rows of the whole batch's masks, so a mesh step equals the unsharded
  step. ZeRO-1 (``shard_optimizer_state``, the default): each Adam moment
  whose dim 0 the data axis divides is split on it, each shard updates its
  rows of the moments and the parameters on its device, and the rows are
  copied back to the lead leaves; clipping by the global norm stays global.
  FSDP (a full finetune with ``shard_params_data_axis``,
  ``parallel/fsdp.py``): the parameters and their moments are split per
  leaf, gathered where used, and updated piece by piece on their devices.
  Base parameters split over the model axis (``parallel/tp.py``) run in the
  megatron form. Checkpoints hold whole tensors in every case, so a run
  resumes with or without a mesh.

- Over a mesh whose data axis spans processes (``parallel.mesh.make_mesh``
  under ``parallel.multihost.initialize_multihost``; the JAX package's mesh
  over DCN): every process collates the same global batch, as every JAX
  process feeds the same global array, and runs its data shards' rows of
  each micro-batch (``lora_rows`` carries the global row, so dropout equals
  the one-process mesh's). The loss is ``sharded_info_nce_loss`` over the
  processes: its value the global loss, its gradient this process's share,
  so the all-reduced (summed) gradients of the whole leaves are the global
  loss's; FSDP pieces get theirs reduce-scattered by the gather's
  backward. Clipping takes the global norm. ZeRO-1 moments are split over
  the global data axis: each process updates its rows, then the leaf's
  rows are all-gathered. FSDP pieces are updated where they live.
  Checkpoints are gathered whole by every process and written by the
  primary one alone; ``merged_params`` gathers in every process. The
  collectives of a step run in autograd's order, which is the same in
  every process only with one device per process: an FSDP split over
  processes with several local devices raises.
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
    batch_images, encode_any, image_input_spec, mrope_ids_for_batch)
from mllm_sparse_retrieval_tpu_torch.models.layers import FLASH_MIN_SEQ
from mllm_sparse_retrieval_tpu_torch.models.quantization import (
    QuantizedWeight, quantized_leaves, tree_to)
from mllm_sparse_retrieval_tpu_torch.ops.tile_kernel import StagedTiles
from mllm_sparse_retrieval_tpu_torch.parallel import fsdp, multihost
from mllm_sparse_retrieval_tpu_torch.parallel.mesh import (
    DATA_AXIS, Mesh, Sharded, split, tree_map)
from mllm_sparse_retrieval_tpu_torch.pipelines.encode import (
    default_pixel_loader, default_raw_image_loader)
from mllm_sparse_retrieval_tpu_torch.tracing import span
from mllm_sparse_retrieval_tpu_torch.train.contrastive import (
    info_nce_loss, sharded_info_nce_loss)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8     # optax.adam defaults
CHECKPOINT_FILE = "checkpoint.pt"
# bytes of (trainable leaves, Adam moments) that train()'s steps in flight
# may stand for before it blocks (the JAX trainer's constant)
SYNC_BUDGET_BYTES = 2e9


@dataclass
class TrainBatch:
    text_ids: np.ndarray      # [B, Tt]
    text_mask: np.ndarray     # [B, Tt]
    image_ids: np.ndarray     # [B, Ti]
    image_mask: np.ndarray    # [B, Ti]
    # [B, H, W, 3] (LLaVA), [B, S, pd] (Qwen, fixed grid), a dict of
    # arrays (anyres, Qwen native), or InternVL's [B, tiles, S, S, 3] tiles
    # as a StagedTiles (made where _to_device puts them; np.asarray makes
    # them on the host)
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
        with span("collate", images=len(batch)):
            return _collate(batch, text_max_len)

    def _collate(batch, text_max_len) -> TrainBatch:
        text_rows = [
            tokenizer.encode(template.fill_text(template.text_prompt(), e.text))
            for e in batch]
        t_ids, t_mask = tokenizer.pad_batch(
            text_rows, max_len=text_max_len, pad_to_multiple=seq_pad_multiple)
        if spec.variable:
            pixels, counts = batch_images(
                spec, [pixel_loader(e) for e in batch])
            img_rows = [tokenizer.encode(template.expand_image(base_prompt, n))
                        for n in counts]
            i_ids, i_mask = tokenizer.pad_batch(
                img_rows, max_len=img_fixed_len,
                pad_to_multiple=seq_pad_multiple)
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


def zero1_shardings(tree, mesh: Mesh):
    """ZeRO-1 spec tuples: a leaf's dim 0 over ``"data"`` when the
    (global) data axis divides it, whole (``()``) otherwise."""
    n = mesh.data_size

    def leaf(_, x):
        shape = tuple(getattr(x, "shape", ()))
        if shape and shape[0] % n == 0 and shape[0] > 0:
            return (DATA_AXIS,)
        return ()

    return tree_map(leaf, tree)


def _leaves(tree) -> list:
    """Leaves of a tree in tree order, a ``Sharded`` as one leaf, a
    ``QuantizedWeight`` as its stored tensors."""
    if isinstance(tree, QuantizedWeight):
        return tree.tensors()
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _tensors(leaf) -> List[torch.Tensor]:
    return leaf.tensors() if isinstance(leaf, Sharded) else [leaf]


def _spans_processes(leaf) -> bool:
    """A ``Sharded`` split over processes (or holding such pieces)."""
    return isinstance(leaf, Sharded) and (
        leaf.processes > 1 or any(_spans_processes(p) for p in leaf.pieces))


def _gathered(tree, device):
    """``tree`` with every ``Sharded`` leaf whole on ``device``."""
    return tree_map(lambda _, x: x.gather(device) if isinstance(x, Sharded)
                    else x, tree)


def _zeros_like(x):
    """Zeros shaped and placed like ``x`` (a tensor or a ``Sharded``)."""
    if isinstance(x, Sharded):
        return Sharded([_zeros_like(p) for p in x.pieces], x.devices, x.dim,
                       x.spec, x.process_index, x.processes)
    return torch.zeros_like(x, requires_grad=False)


def _assign(dst, src: torch.Tensor) -> None:
    """Copy the whole tensor ``src`` into ``dst`` (a tensor, or the pieces
    of a ``Sharded``: this process's own)."""
    if not isinstance(dst, Sharded):
        dst.copy_(src)
        return
    step = src.shape[dst.dim] // (len(dst.pieces) * dst.processes)
    for j, piece in enumerate(dst.pieces):
        _assign(piece, src.narrow(dst.dim, (dst.piece_offset + j) * step,
                                  step))


def _nbytes(x) -> int:
    """The bytes of a whole leaf (a tensor or a ``Sharded``)."""
    return math.prod(x.shape) * x.dtype.itemsize


def _as_float(x) -> float:
    """``float(x)``; NaN where reading ``x`` raises (a step that failed on
    the card), so that ``train()``'s ``finally`` lets the step's own
    exception propagate."""
    try:
        return float(x)
    except Exception:           # whatever a poisoned device value raises
        return float("nan")


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
                 cfg: TrainConfig, mesh: Optional[Mesh] = None,
                 reps_loc: RepsLoc = RepsLoc.BEFORE_PAD, device="cuda"):
        """``mesh`` (a ``parallel.mesh.Mesh``) trains over its data shards
        and replaces ``device`` by ``mesh.lead``; see the module
        docstring."""
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if (cfg.train_full or adapters is None) and quantized_leaves(params):
            raise ValueError(
                "full finetune over a k-bit quantized tree is not "
                "supported (int weights are not trainable) — kbit "
                "loading pairs with LoRA adapters (QLoRA), matching "
                "the reference's prepare_model_for_kbit_training")
        if cfg.lr_schedule not in ("linear", "cosine", "constant"):
            raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}: "
                             "'linear', 'cosine', or 'constant'")
        if cfg.lr_schedule in ("linear", "cosine") and cfg.total_steps <= 0:
            raise ValueError(f"lr_schedule={cfg.lr_schedule!r} needs "
                             f"total_steps")
        self.mesh = mesh
        self.full_finetune = cfg.train_full or adapters is None
        self.processes = 1 if mesh is None else mesh.processes
        if self.processes > 1 and self.full_finetune and \
                cfg.shard_params_data_axis and len(set(mesh.devices.flat)) > 1:
            raise ValueError(
                "FSDP over processes gathers in autograd's order, which "
                "is one order in every process only with one device per "
                f"process; this process has {len(set(mesh.devices.flat))}")
        if mesh is not None:
            device = mesh.lead
            if self.full_finetune and cfg.shard_params_data_axis:
                params = fsdp.shard_params_fsdp(params, mesh)
            elif self.full_finetune:
                params = tree_to(params, device)
            else:
                adapters = tree_to(adapters, device)
        self.params = params
        self.arch = arch
        self.cfg = cfg
        self.reps_loc = reps_loc
        self.device = torch.device(device)
        self.adapters = None if self.full_finetune else adapters
        self.step = 0
        self.loss_history: List[float] = []
        for x in _leaves(params):
            for t in _tensors(x):
                t.requires_grad_(self.full_finetune and t.is_floating_point())
        for x in self._trainable_leaves():
            x.requires_grad_(True)
        self.opt_state = {"count": 0,
                          "mu": [self._moment(x) for x in self._leaves()],
                          "nu": [self._moment(x) for x in self._leaves()]}
        # frozen base params as each data shard reads them (one copy per
        # distinct device)
        self._base = None
        if mesh is not None and not self.full_finetune:
            views = {}
            for d in mesh.shard_devices:
                if d not in views:
                    views[d] = fsdp.local_view(params, d)
            self._base = [views[d] for d in mesh.shard_devices]

    def _trainable(self):
        return self.params if self.full_finetune else self.adapters

    def _leaves(self) -> list:
        """The trainable leaves, a ``Sharded`` (FSDP) as one leaf."""
        return [x for x in _leaves(self._trainable())
                if x.dtype.is_floating_point]

    def _trainable_leaves(self) -> List[torch.Tensor]:
        """The tensors that take gradients: the leaves, a ``Sharded``'s
        pieces in its place."""
        return [t for x in self._leaves() for t in _tensors(x)]

    def _moment(self, x):
        """A zero Adam moment for leaf ``x``: split like it under FSDP
        (whole beside a whole leaf, as the JAX package's FSDP specs of the
        moments give), on dim 0 over the data shards under ZeRO-1 when they
        divide it, else beside it."""
        if isinstance(x, Sharded):
            return _zeros_like(x)
        zeros = torch.zeros_like(x, requires_grad=False)
        mesh = self.mesh
        fsdp_on = self.full_finetune and self.cfg.shard_params_data_axis
        if mesh is None or not self.cfg.shard_optimizer_state or fsdp_on \
                or zero1_shardings(x, mesh) == ():
            return zeros
        return split(zeros, 0, mesh.shard_devices, (DATA_AXIS,), mesh)

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

    def _to_device(self, batch: TrainBatch, lo: int, hi: int, device=None):
        """Rows ``lo:hi`` of the batch on ``device``. On CUDA each array is
        copied into pinned host memory and uploaded with ``non_blocking``:
        the copy queues behind the card's work instead of waiting for it
        (PyTorch's caching host allocator keeps each pinned buffer until
        its copy has run). InternVL's staged tiles are made there
        (``StagedTiles.to``: the tile kernel on CUDA)."""
        device = torch.device(self.device if device is None else device)

        def put(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if device.type != "cuda":
                return t.to(device, dtype)
            host = torch.empty(t.shape, dtype=dtype or t.dtype,
                               pin_memory=True)
            return host.copy_(t).to(device, non_blocking=True)

        pixels = batch.pixels
        if isinstance(pixels, dict):
            pixels = {k: put(v[lo:hi]) for k, v in pixels.items()}
        elif isinstance(pixels, StagedTiles):
            pixels = pixels[lo:hi].to(device)
        else:
            pixels = put(pixels[lo:hi])
        pos = batch.image_pos_ids
        if pos is not None:          # [3, B, T]: the batch axis is the 2nd
            pos = put(pos[:, lo:hi], torch.long)
        return (put(batch.text_ids[lo:hi], torch.long),
                put(batch.text_mask[lo:hi]),
                put(batch.image_ids[lo:hi], torch.long),
                put(batch.image_mask[lo:hi]), pixels, pos)

    def _encode(self, params, adapters, t_ids, t_mask, i_ids, i_mask,
                pixels, pos, seed: int, allow_flash=True, lora_rows=None):
        """The text and image embeddings of one (shard of a) micro-batch."""
        cfg = self.cfg
        dropout = 0.0 if self.full_finetune else cfg.lora_dropout
        t_seed = i_seed = None
        if dropout > 0.0:
            t_seed, i_seed = L.fold_seed(seed, 0), L.fold_seed(seed, 1)
        _, t_emb = encode_any(params, self.arch, t_ids, t_mask, None,
                              self.reps_loc, adapters, remat=cfg.remat,
                              allow_flash=allow_flash, lora_seed=t_seed,
                              lora_dropout=dropout, lora_rows=lora_rows)
        _, i_emb = encode_any(params, self.arch, i_ids, i_mask, pixels,
                              self.reps_loc, adapters,
                              position_ids=pos, remat=cfg.remat,
                              allow_flash=allow_flash, lora_seed=i_seed,
                              lora_dropout=dropout, lora_rows=lora_rows)
        return t_emb, i_emb

    def _loss(self, t_ids, t_mask, i_ids, i_mask, pixels, pos,
              seed: int) -> torch.Tensor:
        t_emb, i_emb = self._encode(self.params, self.adapters, t_ids,
                                    t_mask, i_ids, i_mask, pixels, pos, seed)
        return info_nce_loss(t_emb, i_emb, self.cfg.tau)

    def _mesh_loss(self, batch: TrainBatch, lo: int, hi: int,
                   seed: int) -> torch.Tensor:
        """The loss of rows ``lo:hi`` split over the (global) data shards:
        this process runs its own."""
        mesh = self.mesh
        per = (hi - lo) // mesh.data_size
        t_embs, i_embs = [], []
        for i, dev in enumerate(mesh.shard_devices):
            if self.full_finetune:
                params, adapters = fsdp.local_view(self.params, dev), None
            else:
                params = self._base[i]
                adapters = tree_to(self.adapters, dev)
            row = (mesh.data_offset + i) * per
            with span("to_device"):
                inputs = self._to_device(batch, lo + row, lo + row + per,
                                         dev)
            t_emb, i_emb = self._encode(
                params, adapters, *inputs, seed, allow_flash=mesh.row(i),
                lora_rows=(row, hi - lo))
            t_embs.append(t_emb)
            i_embs.append(i_emb)
        if self.processes > 1 or not self.cfg.gather_save_gradient:
            return sharded_info_nce_loss(
                mesh, t_embs, i_embs, self.cfg.tau,
                gather_save_gradient=self.cfg.gather_save_gradient)
        return info_nce_loss(torch.cat([t.to(mesh.lead) for t in t_embs]),
                             torch.cat([x.to(mesh.lead) for x in i_embs]),
                             self.cfg.tau)

    def train_on_batch(self, batch: TrainBatch, blocking: bool = True):
        """One optimizer step on a collated batch; returns the loss, a float.
        ``blocking=False`` returns it as a detached 0-d tensor on the
        trainer's device without waiting for the card (``loss_history``
        holds the tensor until ``train()`` turns it into a float). The step
        is a ``train_step`` span around ``to_device``, ``forward``,
        ``backward`` (``autograd.grad``) and ``optimizer`` spans."""
        with span("train_step"):
            return self._step(batch, blocking)

    def _step(self, batch: TrainBatch, blocking: bool):
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
        n_data = 1 if self.mesh is None else self.mesh.data_size
        if m % n_data:
            raise ValueError(f"micro-batch of {m} rows does not split over "
                             f"{n_data} data shards")
        leaves = self._trainable_leaves()
        step_seed = L.fold_seed(self.cfg.seed, self.step)
        total = loss_sum = None
        for i in range(accum):
            seed = step_seed if accum == 1 else L.fold_seed(step_seed, i)
            if self.mesh is None:
                with span("to_device"):
                    inputs = self._to_device(batch, i * m, (i + 1) * m)
                with span("forward"):
                    loss = self._loss(*inputs, seed)
            else:
                with span("forward"):
                    loss = self._mesh_loss(batch, i * m, (i + 1) * m, seed)
            with span("backward"):
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
        if self.processes > 1:
            # each process holds its share of the global loss's gradient
            # for the whole leaves; FSDP pieces already hold the sum
            owners = [x for x in self._leaves() for _ in _tensors(x)]
            multihost.all_reduce_([g for x, g in zip(owners, grads)
                                   if not _spans_processes(x)])
        with span("optimizer"):
            self._update(leaves, grads)
        self.step += 1
        loss = self._retire(loss_sum) if blocking else loss_sum
        self.loss_history.append(loss)
        return loss

    def _retire(self, loss: torch.Tensor) -> float:
        """The host sync of a blocking step: its loss as a float."""
        return float(loss)

    def _drain(self) -> None:
        """The host sync of ``train()``'s stride: wait until every step
        queued on the trainer's cards has run."""
        devices = {self.device}
        if self.mesh is not None:
            devices.update(self.mesh.devices.flat)
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _sync_stride(self) -> int:
        """``train()`` blocks every this many steps that do not sync
        anyway: ``SYNC_BUDGET_BYTES`` over the bytes of the trainable leaves
        and their Adam moments, clamped to 1..32 (the JAX trainer's
        ``sync_stride``)."""
        st = self.opt_state
        step_bytes = sum(_nbytes(x) for x in
                         self._leaves() + st["mu"] + st["nu"])
        return max(1, min(32, int(SYNC_BUDGET_BYTES // max(step_bytes, 1))))

    @torch.no_grad()
    def _update(self, leaves, grads) -> None:
        cfg = self.cfg
        st = self.opt_state
        max_norm = cfg.max_grad_norm
        if max_norm and max_norm > 0:
            owners = [x for x in self._leaves() for _ in _tensors(x)]
            sq = [((g * g).sum().to(self.device), _spans_processes(x))
                  for x, g in zip(owners, grads)]
            norm = sum(q for q, span in sq if not span)
            pieces = [q for q, span in sq if span]
            if pieces:                   # FSDP pieces over processes
                pieces = torch.stack(pieces).sum()
                multihost.all_reduce_([pieces])
                norm = norm + pieces
            norm = norm.sqrt()
            keep = norm < max_norm
            grads = [torch.where(keep.to(g.device), g,
                                 (g / norm.to(g.device, g.dtype)) * max_norm)
                     for g in grads]
        lr = self.learning_rate(st["count"])
        count = st["count"] + 1
        c1, c2 = 1 - ADAM_B1 ** count, 1 - ADAM_B2 ** count

        def adam(x, g, mu, nu):
            mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
            nu.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * nu)
            u = (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)
            if cfg.weight_decay > 0:
                u = u + cfg.weight_decay * x
            x.add_((u * -lr).to(x.dtype))

        grads = iter(grads)
        spread = []          # (leaf, its rows here) of ZeRO-1 over processes
        for leaf, mu, nu in zip(self._leaves(), st["mu"], st["nu"]):
            if isinstance(leaf, Sharded):        # FSDP: piece by piece
                for x, m, v in zip(leaf.tensors(), mu.tensors(),
                                   nu.tensors()):
                    adam(x, next(grads), m, v)
            elif isinstance(mu, Sharded):        # ZeRO-1: rows per shard
                g = next(grads)
                step = leaf.shape[0] // (len(mu.pieces) * mu.processes)
                for j, dev in enumerate(mu.devices):
                    k = mu.piece_offset + j
                    rows = slice(k * step, (k + 1) * step)
                    x = leaf[rows].to(dev)
                    adam(x, g[rows].to(dev), mu.pieces[j], nu.pieces[j])
                    leaf[rows].copy_(x)
                if mu.processes > 1:
                    spread.append((leaf, leaf[mu.piece_offset * step:(
                        mu.piece_offset + len(mu.pieces)) * step]))
            else:
                adam(leaf, next(grads), mu, nu)
        if spread:                           # every process's rows
            for (leaf, _), whole in zip(spread, multihost.all_gather_each(
                    [r for _, r in spread])):
                leaf.copy_(whole)
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
        (seed)``) and drop-last batching, as the JAX trainer runs it: only
        the steps that log or checkpoint block, and every
        ``_sync_stride()``-th step besides (see the module docstring)."""
        num_epochs = num_epochs or self.cfg.num_epochs
        rng = np.random.default_rng(seed)
        order = np.arange(len(examples))
        every = self.cfg.checkpoint_every_steps
        stride = self._sync_stride()
        try:
            for epoch in range(num_epochs):
                rng.shuffle(order)
                for start in range(0, len(examples) - batch_size + 1,
                                   batch_size):
                    batch_ex = [examples[i]
                                for i in order[start:start + batch_size]]
                    # log_every=0 logs nothing
                    want_sync = bool(
                        (logger and log_every and
                         (self.step + 1) % log_every == 0) or
                        (checkpoint_dir and every and
                         (self.step + 1) % every == 0))
                    loss = self.train_on_batch(
                        collate(batch_ex, text_max_len), blocking=want_sync)
                    if not want_sync and self.step % stride == 0:
                        self._drain()
                    if logger and log_every and self.step % log_every == 0:
                        logger(f"epoch {epoch} step {self.step} "
                               f"loss {loss:.4f}")
                    if checkpoint_dir and every and self.step % every == 0:
                        self.save_checkpoint(checkpoint_dir)
        finally:
            self.loss_history = [_as_float(x) for x in self.loss_history]
        if checkpoint_dir:
            self.save_checkpoint(checkpoint_dir)
        return self.loss_history

    def merged_params(self) -> Dict:
        """Fold trained adapters into the base params (inference form);
        split leaves come back whole on the trainer's device."""
        params = _gathered(self.params, self.device)
        if self.full_finetune:
            return params
        return lora_lib.merge_lora(params, self.adapters)

    # ---- checkpoints ---------------------------------------------------------

    def save_checkpoint(self, directory: str) -> None:
        """``<directory>/step_<n>/checkpoint.pt`` (the trainable tree and the
        optimizer state, every tensor whole) and ``<directory>/latest``.
        Over processes every process calls it (split leaves are gathered)
        and the primary one writes; it returns once the files are there."""
        def cpu(x):
            return (x.gather("cpu") if isinstance(x, Sharded)
                    else x).detach().cpu()

        st = self.opt_state
        state = {"adapters": tree_map(lambda _, x: cpu(x), self._trainable()),
                 "opt_state": {"count": st["count"],
                               "mu": [cpu(x) for x in st["mu"]],
                               "nu": [cpu(x) for x in st["nu"]]}}
        if multihost.is_primary_host():
            path = os.path.join(directory, f"step_{self.step}")
            os.makedirs(path, exist_ok=True)
            torch.save(state, os.path.join(path, CHECKPOINT_FILE))
            with open(os.path.join(directory, "latest"), "w") as f:
                f.write(str(self.step))
        if self.processes > 1:
            multihost.barrier()

    @torch.no_grad()
    def restore_checkpoint(self, directory: str,
                           step: Optional[int] = None) -> int:
        """Load ``step`` (default: ``latest``) into this trainer's trainable
        tensors and optimizer state, in place (split leaves piece by
        piece); returns the step."""
        if step is None:
            with open(os.path.join(directory, "latest")) as f:
                step = int(f.read().strip())
        saved = torch.load(
            os.path.join(directory, f"step_{step}", CHECKPOINT_FILE),
            map_location="cpu", weights_only=True)
        mine = _leaves(self._trainable())
        theirs = lora_lib.tree_leaves(saved["adapters"])
        if [tuple(x.shape) for x in mine] != [tuple(x.shape) for x in theirs]:
            raise ValueError(f"checkpoint at step {step} does not match the "
                             f"trainable tree")
        for x, y in zip(mine, theirs):
            _assign(x, y)
        st = self.opt_state
        st["count"] = int(saved["opt_state"]["count"])
        for key in ("mu", "nu"):
            for x, y in zip(st[key], saved["opt_state"][key]):
                _assign(x, y)
        self.step = step
        return step

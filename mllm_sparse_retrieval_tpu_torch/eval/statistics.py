"""Diagnostics: term-weight distributions and fusion-provenance rank
analysis (the JAX package's ``eval/statistics.py``).

- ``term_weight_statistics``: for each image, the sparse weights of the
  vocabulary tokens that appear in its ground-truth captions against those
  that do not (and the same for the captions themselves); the separation of
  the two populations is what makes caption-restricted sparse retrieval
  work.
- ``fusion_provenance_statistics``: the fused ranks at which dense-only,
  sparse-only and both-retrieved documents land
  (``search.fusion.fuse_statistic``).

Both return numpy arrays; ``plot_*`` render the histograms as PNGs with
matplotlib, imported when they are called, as in the JAX package.

The image weights of the fixed-grid families are encoded as the JAX
package encodes them: one prompt of ``num_image_tokens`` image slots for
every image, the pixels from ``pixel_loader`` (the model's pixel input;
by default the synthetic loader through ``spec.preprocess``) and, for
Qwen2.5-VL, the prompt's M-RoPE ids. The JAX package's function cannot
encode the variable families' images (their specs have no
``preprocess``); here those go through ``train.trainer.make_collator``,
each prompt with its image's own token count, padded to the family length,
with its tiles or patches and (Qwen at native resolution) the M-RoPE ids
of its own grid; ``pixel_loader`` then returns a raw ``[H, W, 3]`` image.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc
from mllm_sparse_retrieval_tpu_torch.data.karpathy import (
    CrossModalCorpus, Example)
from mllm_sparse_retrieval_tpu_torch.ops.tile_kernel import StagedTiles
from mllm_sparse_retrieval_tpu_torch.search.fusion import fuse_statistic
from mllm_sparse_retrieval_tpu_torch.search.runs import Run
from mllm_sparse_retrieval_tpu_torch.sparse.term_selection import (
    text_candidate_ids)


@dataclass
class TermWeightStats:
    image_in_text: np.ndarray       # image sparse weights on in-caption tokens
    image_out_text: np.ndarray      # ... on out-of-caption tokens
    text_in_text: np.ndarray        # caption weights on its own tokens
    text_out_text: np.ndarray

    def summary(self) -> str:
        def s(x):
            return f"n={x.size} mean={x.mean():.3f}" if x.size else "n=0"
        return (f"image in-text {s(self.image_in_text)} | "
                f"image out-text {s(self.image_out_text)} | "
                f"text in-text {s(self.text_in_text)} | "
                f"text out-text {s(self.text_out_text)}")


def term_weight_statistics(
    corpus: CrossModalCorpus,
    params, arch, tokenizer, template,
    *,
    sparse_cfg,
    num_images: int = 100,
    batch_size: int = 8,
    mesh=None,
    lora=None,
    pixel_loader=None,
    device="cuda",
) -> TermWeightStats:
    """Collect in-caption vs out-of-caption sparse weight populations.
    ``sparse_cfg`` is taken for the JAX package's signature: the weights
    are the full-vocabulary ones, before any term selection. ``mesh``
    splits every batch over its data axis (``encode_examples``' rule)."""

    def encode_word(w):
        return tokenizer.encode(w, add_special_tokens=False)

    vocab_size = tokenizer.vocab_size
    images = corpus.examples_single()[:num_images]
    img_logits = _raw_sparse(images, params, arch, tokenizer, template,
                             "image", batch_size, lora, pixel_loader, device,
                             mesh)

    cap_examples: List[Example] = []
    cap_owner: List[int] = []
    for i, ex in enumerate(images):
        for tid in corpus.img2text[ex.img_id]:
            cap_examples.append(Example(corpus.text_dict[tid], ex.image_path,
                                        tid, ex.img_id))
            cap_owner.append(i)
    cap_logits = _raw_sparse(cap_examples, params, arch, tokenizer, template,
                             "text", batch_size, lora, pixel_loader, device,
                             mesh)

    # per image: union of candidate token ids over its ground-truth captions
    img_in, img_out, txt_in, txt_out = [], [], [], []
    caps_of: Dict[int, List[int]] = {}
    for ci, oi in enumerate(cap_owner):
        caps_of.setdefault(oi, []).append(ci)
    for i, ex in enumerate(images):
        ids = set()
        for ci in caps_of.get(i, []):
            ids.update(text_candidate_ids(cap_examples[ci].text,
                                          encode_word).tolist())
        mask = np.zeros(vocab_size, bool)
        mask[list(ids)] = True
        row = img_logits[i][:vocab_size]
        img_in.append(row[mask])
        img_out.append(row[~mask])
        for ci in caps_of.get(i, []):
            own = np.zeros(vocab_size, bool)
            own[text_candidate_ids(cap_examples[ci].text, encode_word)] = True
            crow = cap_logits[ci][:vocab_size]
            txt_in.append(crow[own])
            txt_out.append(crow[~own])

    def cat(xs):
        return np.concatenate(xs) if xs else np.zeros(0, np.float32)

    return TermWeightStats(cat(img_in), cat(img_out), cat(txt_in),
                           cat(txt_out))


def _raw_sparse(examples, params, arch, tokenizer, template, encode_type,
                batch_size, lora, pixel_loader, device, mesh=None):
    """Full-vocabulary sparse weights per example (before top-k), f32.
    Under a ``mesh`` each batch splits over the data axis, shard ``i`` on
    ``mesh.shard_devices[i]`` with its own parameter copy and the flash
    kernel over its row of the mesh."""
    from mllm_sparse_retrieval_tpu_torch.models.api import (
        encode_any, image_input_spec, mrope_ids_for_batch)
    from mllm_sparse_retrieval_tpu_torch.parallel.mesh import (
        DATA_AXIS, replicated)
    from mllm_sparse_retrieval_tpu_torch.pipelines.encode import (
        _pad_batch_examples, default_pixel_loader)
    from mllm_sparse_retrieval_tpu_torch.train.trainer import make_collator

    if mesh is None:
        shards = [(params, lora, torch.device(device), True)]
    else:
        n_data = mesh.shape[DATA_AXIS]
        if batch_size % n_data:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"data axis {n_data}")
        shards = list(zip(replicated(mesh, params), replicated(mesh, lora),
                          mesh.shard_devices,
                          [mesh.row(i) for i in range(n_data)]))
    step = batch_size // len(shards)
    spec = image_input_spec(arch)

    collate = fixed = None
    if encode_type == "image":
        if spec.variable:
            collate = make_collator(tokenizer, template, arch, pixel_loader)
        else:
            if pixel_loader is None:
                raw_loader = default_pixel_loader(spec.image_size)

                def pixel_loader(e):
                    return spec.preprocess(raw_loader(e))

            prompt = template.image_prompt().replace(
                "<image>", " ".join(["<image>"] * spec.num_image_tokens))
            ids, mask = tokenizer.pad_batch(
                [tokenizer.encode(prompt)] * batch_size, pad_to_multiple=16)
            pos = mrope_ids_for_batch(arch, ids, mask) \
                if spec.needs_mrope else None
            fixed = (ids, mask, pos)

    out = []
    with torch.inference_mode():
        for start in range(0, len(examples), batch_size):
            batch = _pad_batch_examples(examples[start:start + batch_size],
                                        batch_size)
            valid = min(batch_size, len(examples) - start)
            pixels = pos = None
            if encode_type == "text":
                prompts = [template.fill_text(template.text_prompt(), e.text)
                           for e in batch]
                ids, mask = tokenizer.pad_batch(
                    [tokenizer.encode(p) for p in prompts],
                    pad_to_multiple=16)
            elif collate is not None:
                b = collate(batch)
                ids, mask, pixels = b.image_ids, b.image_mask, b.pixels
                pos = b.image_pos_ids
            else:
                ids, mask, pos = fixed
                pixels = np.stack([pixel_loader(e) for e in batch])
            rows = []
            for i, (p, l, dev, flash) in enumerate(shards):
                lo, hi = i * step, (i + 1) * step

                def put(a, dtype=None, axis=0):
                    a = a[lo:hi] if axis == 0 else a[:, lo:hi]
                    if isinstance(a, StagedTiles):
                        return a.to(dev)
                    return torch.from_numpy(np.ascontiguousarray(a)).to(
                        dev, dtype)

                d_px = None if pixels is None else (
                    {k: put(v) for k, v in pixels.items()}
                    if isinstance(pixels, dict) else put(pixels))
                # M-RoPE ids are [3, B, T]: the batch is their second axis
                d_pos = None if pos is None else put(pos, torch.long, 1)
                s, _ = encode_any(p, arch, put(ids, torch.long), put(mask),
                                  d_px, RepsLoc.BEFORE_PAD, l,
                                  position_ids=d_pos, allow_flash=flash)
                rows.append(s.float().cpu().numpy())
            out.append(np.concatenate(rows)[:valid])
    return np.concatenate(out) if out else \
        np.zeros((0, tokenizer.vocab_size), np.float32)


@dataclass
class ProvenanceStats:
    dense_ranks: np.ndarray     # final fused rank of dense-only docs
    sparse_ranks: np.ndarray
    fused_ranks: np.ndarray

    def summary(self) -> str:
        def s(x):
            return f"n={x.size} median={np.median(x):.0f}" if x.size else "n=0"
        return (f"dense-only {s(self.dense_ranks)} | "
                f"sparse-only {s(self.sparse_ranks)} | "
                f"fused {s(self.fused_ranks)}")


def fusion_provenance_statistics(
    dense_run: Run,
    sparse_run: Run,
    alpha: float = 0.5,
    top_n: int = 200,
) -> ProvenanceStats:
    """Ranks (1-based, within ``top_n``) at which dense-only / sparse-only /
    both-sourced docs land after fusion."""
    tagged = fuse_statistic([dense_run, sparse_run], [alpha, 1.0 - alpha])
    dense_ranks, sparse_ranks, fused_ranks = [], [], []
    for qid, docs in tagged.items():
        ordered = sorted(docs.items(), key=lambda kv: kv[1].score,
                         reverse=True)[:top_n]
        for rank, (doc, rec) in enumerate(ordered, start=1):
            if rec.type == "dense":
                dense_ranks.append(rank)
            elif rec.type == "sparse":
                sparse_ranks.append(rank)
            else:
                fused_ranks.append(rank)
    return ProvenanceStats(np.asarray(dense_ranks), np.asarray(sparse_ranks),
                           np.asarray(fused_ranks))


# ---------------------------------------------------------------------------
# Plotting (matplotlib, imported at call time)
# ---------------------------------------------------------------------------

def plot_term_weight_stats(stats: TermWeightStats, out_dir: str) -> List[str]:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    panels = [
        ("image_weights", [("in caption", stats.image_in_text),
                           ("out of caption", stats.image_out_text)]),
        ("text_weights", [("in caption", stats.text_in_text),
                          ("out of caption", stats.text_out_text)]),
        ("in_text_compare", [("image", stats.image_in_text),
                             ("text", stats.text_in_text)]),
    ]
    for name, series in panels:
        fig, ax = plt.subplots(figsize=(7, 4))
        for label, data in series:
            if data.size:
                ax.hist(data, bins=60, alpha=0.55, label=label, density=True)
        ax.set_title(name.replace("_", " "))
        ax.set_xlabel("sparse weight")
        ax.legend()
        path = os.path.join(out_dir, f"{name}.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)
    return paths


def plot_provenance_stats(stats: ProvenanceStats, out_dir: str) -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(7, 4))
    for label, data in (("dense-only", stats.dense_ranks),
                        ("sparse-only", stats.sparse_ranks),
                        ("fused", stats.fused_ranks)):
        if data.size:
            ax.hist(data, bins=50, alpha=0.55, label=label)
    ax.set_xlabel("fused rank")
    ax.set_ylabel("count")
    ax.set_title("fusion provenance rank distribution")
    ax.legend()
    path = os.path.join(out_dir, "provenance_ranks.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path

"""Query encoding with device term selection (the JAX package's
``pipelines/encode.py``, the parts the online text and image paths and the
trainer's collator run).

``make_text_ds_encode`` / ``make_image_ds_encode`` return a plain function
(PyTorch runs eagerly; the JAX package jits the same body) that runs the
model under ``torch.inference_mode()``, selects terms on the device and
packs everything the host needs into ONE int32 tensor, plus the
``unpack_blocks`` spec for it.
``resolve_text_ds_rows`` / ``resolve_image_ds_rows`` turn the unpacked
blocks into ``SelectedTerms`` by the reference's per-caption / per-image
rule.
"""

from __future__ import annotations

import os
import zlib
from typing import Callable, List

import numpy as np
import torch
from torch.profiler import record_function

from mllm_sparse_retrieval_tpu_torch.data.karpathy import Example
from mllm_sparse_retrieval_tpu_torch.models.anyres import CLIP_MEAN, CLIP_STD
from mllm_sparse_retrieval_tpu_torch.models.api import encode_any
from mllm_sparse_retrieval_tpu_torch.models.reps import normalize
from mllm_sparse_retrieval_tpu_torch.ops.packing import pack_blocks
from mllm_sparse_retrieval_tpu_torch.ops.select import (
    candidate_topk, filtered_topk, vocab_topk)
from mllm_sparse_retrieval_tpu_torch.sparse.term_selection import (
    SelectedTerms, quantize_weights)


def make_text_ds_encode(arch, reps_loc, k_text_full: int, exp_k: int):
    """``(fn, spec_fn)``: ``fn(params, lora, ids, mask, cand_ids, cand_mask,
    fmask)`` (``lora`` an adapter tree or None) packs (full-vocab top-k,
    candidate top-k [+ expansion top-k], L2-normalized dense) into one
    int32 tensor; ``spec_fn(cand_w)`` gives the matching ``unpack_blocks``
    spec. ``fmask`` is the filtered-vocab bool mask when ``exp_k > 0``, else
    None."""
    hidden = arch.text.hidden_size

    @torch.inference_mode()
    def _fn(p, lora, ids, mask, cand_ids, cand_mask, fmask):
        sparse, dense = encode_any(p, arch, ids, mask, None, reps_loc, lora)
        with record_function("term_select"):
            fv, fi = vocab_topk(sparse, k_text_full)
            cv, ci, cnt = candidate_topk(sparse, cand_ids, cand_mask, 128)
            blocks = [(fv, True), (fi, False), (cv, True), (ci, False),
                      (cnt, False)]
            if fmask is not None:
                # over-provision by the candidate width (the exclusion bound)
                ev, ei = filtered_topk(sparse, fmask,
                                       exp_k + cand_ids.shape[1])
                blocks += [(ev, True), (ei, False)]
            return pack_blocks(blocks + [(normalize(dense), True)])

    def _spec(cand_w):
        # widths mirror the k clamps inside ops/select (k = min(k, width))
        vocab = arch.text.vocab_size
        kt = min(k_text_full, vocab)
        cw = min(128, cand_w)
        spec = [(kt, True), (kt, False), (cw, True), (cw, False), (1, False)]
        if exp_k > 0:
            ew = min(exp_k + cand_w, vocab)
            spec += [(ew, True), (ew, False)]
        return spec + [(hidden, True)]

    return _fn, _spec


def make_image_ds_encode(arch, reps_loc, k_image: int, exp_k: int):
    """Image counterpart of ``make_text_ds_encode``: ``fn(params, lora, ids,
    mask, pixels, fmask)`` packs (full-vocab top-k [+ expansion top-k],
    L2-normalized dense); ``spec_fn()`` is shape-static (image selection has
    no candidate set: the reference takes the top ``sparse_length`` vocab
    terms). ``pixels`` is a pixel tensor or the anyres dict."""
    hidden = arch.text.hidden_size

    @torch.inference_mode()
    def _fn(p, lora, ids, mask, pixels, fmask):
        sparse, dense = encode_any(p, arch, ids, mask, pixels, reps_loc,
                                   lora)
        with record_function("term_select"):
            fv, fi = vocab_topk(sparse, k_image)
            blocks = [(fv, True), (fi, False)]
            if fmask is not None:
                ev, ei = filtered_topk(sparse, fmask, exp_k + k_image)
                blocks += [(ev, True), (ei, False)]
            return pack_blocks(blocks + [(normalize(dense), True)])

    def _spec():
        vocab = arch.text.vocab_size
        ki = min(k_image, vocab)
        spec = [(ki, True), (ki, False)]
        if exp_k > 0:
            ew = min(exp_k + k_image, vocab)
            spec += [(ew, True), (ew, False)]
        return spec + [(hidden, True)]

    return _fn, _spec


def resolve_image_ds_rows(parts, valid: int, sparse_cfg
                          ) -> List[SelectedTerms]:
    """SelectedTerms rows from the unpacked ``make_image_ds_encode`` output
    (``parts`` INCLUDING the trailing dense block): top-k vocab terms,
    optional expansion terms excluding the selected top-k ids."""
    exp_k = sparse_cfg.num_expanded_tokens
    fv, fi = parts[0], parts[1]
    exp = (parts[2], parts[3]) if len(parts) == 5 else None
    out: List[SelectedTerms] = []
    for b in range(valid):
        t_ids, t_vals = fi[b], fv[b]
        if exp is not None:
            # image expansion excludes the selected top-k ids
            t_ids, t_vals = expand_terms(
                t_ids, t_vals, t_ids, (exp[0][b], exp[1][b]), exp_k)
        out.append(SelectedTerms(
            t_ids.astype(np.int32),
            quantize_weights(t_vals, sparse_cfg.quantization_scale)))
    return out


def expand_terms(t_ids, t_vals, excl_ids, exp_row, exp_k: int):
    """Append ``exp_k`` expansion terms: the first exp_k ranked filtered ids
    not in ``excl_ids`` (golden: setdiff1d + topk — same order)."""
    ev, ei = exp_row
    excl = set(int(x) for x in excl_ids)
    neg_inf = np.finfo(np.float32).min
    add_ids, add_vals = [], []
    for v, i in zip(ev, ei):
        if len(add_ids) >= exp_k or v <= neg_inf / 2:
            break
        if int(i) in excl:
            continue
        add_ids.append(int(i))
        add_vals.append(float(v))
    if not add_ids:
        return t_ids, t_vals
    return (np.concatenate([t_ids, np.asarray(add_ids, np.int32)]),
            np.concatenate([t_vals, np.asarray(add_vals, np.float32)]))


def resolve_text_ds_rows(parts, valid: int, cand_ids, cand_mask,
                         sparse_cfg) -> List[SelectedTerms]:
    """SelectedTerms rows from the unpacked ``make_text_ds_encode`` output
    (``parts`` INCLUDING the trailing dense block, ignored here): candidate
    top-k when any in-text candidate scored, full-vocab fallback otherwise,
    manual-mode full-vocab top-``sparse_length``, optional expansion terms
    excluding the caption's own candidates."""
    exp_k = sparse_cfg.num_expanded_tokens
    fv, fi, cv, ci, cnt = parts[0], parts[1], parts[2], parts[3], \
        parts[4][:, 0]
    exp = (parts[5], parts[6]) if len(parts) == 8 else None
    out: List[SelectedTerms] = []
    for b in range(valid):
        if cnt[b] == 0:
            take = sparse_cfg.fallback_top_k
            t_ids, t_vals = fi[b][:take], fv[b][:take]
        elif sparse_cfg.sparse_manual:
            take = sparse_cfg.sparse_length
            t_ids, t_vals = fi[b][:take], fv[b][:take]
        else:
            take = min(int(cnt[b]), 128)
            t_ids, t_vals = ci[b][:take], cv[b][:take]
        if exp is not None:
            excl = cand_ids[b][cand_mask[b]]
            t_ids, t_vals = expand_terms(
                t_ids, t_vals, excl, (exp[0][b], exp[1][b]), exp_k)
        out.append(SelectedTerms(
            t_ids.astype(np.int32),
            quantize_weights(t_vals, sparse_cfg.quantization_scale)))
    return out


def default_pixel_loader(image_size: int) -> Callable[[Example], np.ndarray]:
    """Deterministic synthetic CLIP-normalised ``[S, S, 3]`` pixels for an
    example whose image file is absent (seeded by ``zlib.crc32`` of its
    ``img_id``, as in the JAX package). The port does not decode image files
    (the card machine has no Pillow): for a file that exists it raises, and
    the caller injects a ``pixel_loader`` instead."""
    mean, std = CLIP_MEAN, CLIP_STD

    def load(ex: Example) -> np.ndarray:
        if os.path.exists(ex.image_path):
            raise _file_error(ex)
        # crc32, NOT hash(): str hashes are salted per process
        rng = np.random.default_rng(zlib.crc32(str(ex.img_id).encode()))
        arr = rng.uniform(size=(image_size, image_size, 3)).astype(np.float32)
        return (arr - mean) / std

    return load


def default_raw_image_loader(
    synthetic_size: tuple = (480, 640),
) -> Callable[[Example], np.ndarray]:
    """Deterministic synthetic un-normalised ``[H, W, 3]`` pixels in [0, 1]
    at ``synthetic_size`` for an example whose image file is absent: the
    input form of the variable-token (anyres) families. For a file that
    exists it raises, as ``default_pixel_loader`` does."""

    def load(ex: Example) -> np.ndarray:
        if os.path.exists(ex.image_path):
            raise _file_error(ex)
        rng = np.random.default_rng(zlib.crc32(str(ex.img_id).encode()))
        return rng.uniform(size=synthetic_size + (3,)).astype(np.float32)

    return load


def _file_error(ex: Example) -> NotImplementedError:
    return NotImplementedError(
        f"{ex.image_path} exists, and the port does not decode image files "
        f"(no Pillow on the card machine): pass a pixel_loader that returns "
        f"the image as an [H, W, 3] float array")

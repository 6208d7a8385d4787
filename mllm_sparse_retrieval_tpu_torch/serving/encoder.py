"""Online query encoder: raw text or image -> (dense rep, SelectedTerms) on
the card.

The same encode math as the offline pipeline — the same function factories
and row-resolve helpers (``pipelines.encode.make_{text,image}_ds_encode`` /
``resolve_{text,image}_ds_rows``) — repackaged for serving: every request
batch is padded to ONE fixed shape, as in the JAX package, so a query's
terms do not depend on how requests were batched. Variable-token image
prompts (anyres, InternVL tiling, Qwen native resolution) are padded to the
family's longest prompt, rounded up to a multiple of 512 once it reaches
``FLASH_MIN_SEQ`` so that the decoder takes the flash kernel; Qwen2.5-VL
image batches carry their M-RoPE position ids.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc
from mllm_sparse_retrieval_tpu_torch.models.anyres import resize_bicubic
from mllm_sparse_retrieval_tpu_torch.models.api import (
    image_input_spec, mrope_ids_for_batch)
from mllm_sparse_retrieval_tpu_torch.models.layers import FLASH_MIN_SEQ
from mllm_sparse_retrieval_tpu_torch.ops.packing import unpack_blocks
from mllm_sparse_retrieval_tpu_torch.pipelines.encode import (
    CLIP_MEAN, CLIP_STD, make_image_ds_encode, make_text_ds_encode,
    resolve_image_ds_rows, resolve_text_ds_rows)
from mllm_sparse_retrieval_tpu_torch.sparse.term_selection import (
    get_filtered_ids, text_candidate_ids)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class OnlineQueryEncoder:
    """Text- and image-query encoder over fixed padded shapes.

    ``lora``: an adapter tree (``models/lora.py``) served unmerged, as the
    JAX package's encoder does; every encode runs under
    ``torch.inference_mode()``. ``encode_texts`` / ``encode_images`` are
    not thread-safe by themselves; the service calls them from the
    micro-batcher's single dispatcher thread. Texts longer than
    ``max_text_len`` tokens are truncated; queries with more than
    ``max_candidates`` distinct candidate tokens raise.
    """

    def __init__(self, params, arch, tokenizer, template, sparse_cfg, *,
                 reps_loc: RepsLoc = RepsLoc.BEFORE_PAD, lora=None,
                 max_text_len: int = 64, max_candidates: int = 256,
                 device="cuda"):
        self.params = params
        self.lora = lora
        self.arch = arch
        self.tokenizer = tokenizer
        self.template = template
        self.sparse_cfg = sparse_cfg
        self.reps_loc = reps_loc
        self.device = torch.device(device)
        self.max_text_len = _round_up(max_text_len, 16)
        self.max_candidates = int(max_candidates)
        k_text_full = max(
            sparse_cfg.sparse_length if sparse_cfg.sparse_manual else 0,
            sparse_cfg.fallback_top_k)
        exp_k = sparse_cfg.num_expanded_tokens
        self._fn, spec_fn = make_text_ds_encode(arch, reps_loc, k_text_full,
                                                exp_k)
        self._spec = spec_fn(self.max_candidates)
        self._encode_word = lambda w: tokenizer.encode(
            w, add_special_tokens=False)
        self._fmask = None
        if exp_k > 0:
            fm = np.zeros(arch.text.vocab_size, bool)
            fm[get_filtered_ids(tokenizer.get_vocab())] = True
            self._fmask = torch.from_numpy(fm).to(self.device)
        self._img = None     # lazy image-path state (dict)

    def encode_texts(self, texts: Sequence[str], pad_to: Optional[int] = None
                     ) -> Tuple[np.ndarray, List]:
        """Encode up to ``pad_to`` texts in one fixed-shape call.

        Returns ``(dense [len(texts), d] float32 L2-normalized,
        selected_terms)``; pad rows never resolve.
        """
        n = len(texts)
        b = int(pad_to or n)
        if n == 0 or n > b:
            raise ValueError(f"got {n} texts for a batch of {b}")
        padded = list(texts) + [""] * (b - n)
        prompt = self.template.text_prompt()
        rows = [self.tokenizer.encode(self.template.fill_text(prompt, t))
                for t in padded]
        ids, mask = self.tokenizer.pad_batch(
            rows, max_len=self.max_text_len, pad_to_multiple=16)
        c = self.max_candidates
        cand_ids = np.zeros((b, c), np.int32)
        cand_mask = np.zeros((b, c), bool)
        for i, t in enumerate(texts):
            r = text_candidate_ids(t, self._encode_word)
            if len(r) > c:
                raise ValueError(
                    f"query has {len(r)} candidate tokens; this encoder "
                    f"takes <= {c} (max_candidates)")
            cand_ids[i, : len(r)] = r
            cand_mask[i, : len(r)] = True
        d_ids, d_mask, d_ci, d_cm = (torch.from_numpy(x).to(self.device)
                                     for x in (ids, mask, cand_ids,
                                               cand_mask))
        packed = self._fn(self.params, self.lora, d_ids.long(), d_mask, d_ci,
                          d_cm, self._fmask)
        parts = unpack_blocks(packed.cpu().numpy(), self._spec)
        terms = resolve_text_ds_rows(parts, n, cand_ids, cand_mask,
                                     self.sparse_cfg)
        dense = np.asarray(parts[-1], np.float32)[:n]
        return dense, terms

    # ---- image queries -----------------------------------------------------

    def _image_state(self) -> dict:
        """Lazy image-path state: the encode function, its unpack spec, and
        the family's prompt and pixel plumbing. Variable families pad every
        prompt to the family's longest one, so one shape serves every
        grid."""
        if self._img is not None:
            return self._img
        spec = image_input_spec(self.arch)
        k_image = (self.sparse_cfg.sparse_length
                   if self.sparse_cfg.sparse_manual else 128)
        fn, spec_fn = make_image_ds_encode(
            self.arch, self.reps_loc, k_image,
            self.sparse_cfg.num_expanded_tokens)
        st = {"spec": spec, "fn": fn, "unpack": spec_fn()}
        if spec.variable:
            base = self.template.image_prompt()
            fixed_len = len(self.tokenizer.encode(
                self.template.expand_image(base, spec.max_image_tokens)))
            if fixed_len >= FLASH_MIN_SEQ:
                fixed_len = _round_up(fixed_len, 512)
            st["base_prompt"] = base
            st["fixed_len"] = fixed_len
        else:
            prompt = self.template.expand_image(
                self.template.image_prompt(), spec.num_image_tokens)
            st["row"] = self.tokenizer.encode(prompt)
        self._img = st
        return st

    def _fixed_pixels(self, spec, raw: np.ndarray) -> np.ndarray:
        """Raw [H, W, 3] float in [0, 1] -> the fixed family's pixel layout:
        resized to the square input size (uint8 round trip through the
        PIL-equal bicubic resample when the size differs), CLIP-normalised,
        ``spec.preprocess``."""
        s = spec.image_size
        raw = np.asarray(raw, np.float32)
        if raw.ndim != 3 or raw.shape[2] != 3:
            raise ValueError(f"image must be [H, W, 3], got {raw.shape}")
        if raw.shape[:2] != (s, s):
            u8 = np.clip(raw * 255.0, 0, 255).astype(np.uint8)
            raw = resize_bicubic(u8, (s, s)).astype(np.float32) / 255.0
        return spec.preprocess((raw - CLIP_MEAN) / CLIP_STD)

    def image_inputs(self, images: Sequence[np.ndarray], pad_to: int):
        """Device inputs ``(ids, mask, pixels, pos)`` of one fixed-shape
        image batch: the host preprocessing of ``encode_images``. Pad rows
        repeat the last image. ``pixels`` is a tensor, or the family's dict;
        ``pos`` the ``[3, B, T]`` M-RoPE ids (Qwen2.5-VL) or None."""
        n, b = len(images), int(pad_to)
        if n == 0 or n > b:
            raise ValueError(f"got {n} images for a batch of {b}")
        st = self._image_state()
        spec = st["spec"]
        if spec.variable:
            vitems = [spec.preprocess_example(np.asarray(im, np.float32))
                      for im in images]
            vitems += [vitems[-1]] * (b - n)
            rows = [self.tokenizer.encode(self.template.expand_image(
                st["base_prompt"], nt)) for _, nt in vitems]
            ids, mask = self.tokenizer.pad_batch(
                rows, max_len=st["fixed_len"], pad_to_multiple=16)
            pixels = spec.batch_vision([item for item, _ in vitems])
            pos = (spec.mrope_from_batch(ids, mask, pixels)
                   if spec.mrope_from_batch else None)
        else:
            px = [self._fixed_pixels(spec, im) for im in images]
            px += [px[-1]] * (b - n)
            pixels = np.stack(px)
            ids, mask = self.tokenizer.pad_batch([st["row"]] * b,
                                                 pad_to_multiple=16)
            pos = (mrope_ids_for_batch(self.arch, ids, mask)
                   if spec.needs_mrope else None)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        d_px = ({k: put(v) for k, v in pixels.items()}
                if isinstance(pixels, dict) else put(pixels))
        return (put(ids).long(), put(mask), d_px,
                None if pos is None else put(pos).long())

    def encode_images(self, images: Sequence[np.ndarray],
                      pad_to: Optional[int] = None) -> Tuple[np.ndarray, List]:
        """Encode raw images ([H, W, 3] float in [0, 1], any resolution) in
        one fixed-shape call; same return contract as ``encode_texts``. Pad
        rows never resolve."""
        n = len(images)
        st = self._image_state()
        d_ids, d_mask, d_px, d_pos = self.image_inputs(images, pad_to or n)
        packed = st["fn"](self.params, self.lora, d_ids, d_mask, d_px,
                          d_pos, self._fmask)
        parts = unpack_blocks(packed.cpu().numpy(), st["unpack"])
        terms = resolve_image_ds_rows(parts, n, self.sparse_cfg)
        dense = np.asarray(parts[-1], np.float32)[:n]
        return dense, terms

"""Online query encoder: raw text -> (dense rep, SelectedTerms) on the card.

The same encode math as the offline pipeline — the same function factory and
row-resolve helper (``pipelines.encode.make_text_ds_encode`` /
``resolve_text_ds_rows``) — repackaged for serving: every request batch is
padded to ONE fixed ``(batch, text_len, candidates)`` shape, as in the JAX
package, so a query's terms do not depend on how requests were batched.
Image queries wait for the image-query slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc
from mllm_sparse_retrieval_tpu_torch.ops.packing import unpack_blocks
from mllm_sparse_retrieval_tpu_torch.pipelines.encode import (
    make_text_ds_encode, resolve_text_ds_rows)
from mllm_sparse_retrieval_tpu_torch.sparse.term_selection import (
    get_filtered_ids, text_candidate_ids)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class OnlineQueryEncoder:
    """Text-query encoder over one fixed padded shape.

    ``encode_texts`` is not thread-safe by itself; the service calls it from
    the micro-batcher's single dispatcher thread. Texts longer than
    ``max_text_len`` tokens are truncated; queries with more than
    ``max_candidates`` distinct candidate tokens raise.
    """

    def __init__(self, params, arch, tokenizer, template, sparse_cfg, *,
                 reps_loc: RepsLoc = RepsLoc.BEFORE_PAD,
                 max_text_len: int = 64, max_candidates: int = 256,
                 device="cuda"):
        self.params = params
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
        packed = self._fn(self.params, d_ids.long(), d_mask, d_ci, d_cm,
                          self._fmask)
        parts = unpack_blocks(packed.cpu().numpy(), self._spec)
        terms = resolve_text_ds_rows(parts, n, cand_ids, cand_mask,
                                     self.sparse_cfg)
        dense = np.asarray(parts[-1], np.float32)[:n]
        return dense, terms

"""Offline corpus and query encoding (the JAX package's
``pipelines/encode.py``, one device).

``make_text_ds_encode`` / ``make_image_ds_encode`` return a plain function
(PyTorch runs eagerly; the JAX package jits the same body) that runs the
model under ``torch.inference_mode()``, selects terms on the device and
packs everything the host needs into ONE int32 tensor, plus the
``unpack_blocks`` spec for it.
``resolve_text_ds_rows`` / ``resolve_image_ds_rows`` turn the unpacked
blocks into ``SelectedTerms`` by the reference's per-caption / per-image
rule. The online encoder (``serving/encoder.py``) and the trainer's
collator use these pieces directly.

``encode_examples`` drives them over a list of examples: fixed device
batches (the last one padded by repeating its last example), host
preparation on a prefetch thread, two batches in flight
(``ops/stream.py``). ``write_artifacts`` writes the reference's artifact
formats, which either package reads:

- dense: ``corpus_{shard}.pkl`` / ``query.pkl`` = pickled
  ``(np.ndarray float32 [N, d], ids list)``;
- sparse: ``corpus_{shard}.jsonl`` (one ``{"id", "content", "vector"}``
  document a line) / ``query.tsv`` (id, a tab, each token repeated
  weight-many times).
"""

from __future__ import annotations

import collections
import json
import os
import pickle
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc
from mllm_sparse_retrieval_tpu_torch.data.karpathy import Example
from mllm_sparse_retrieval_tpu_torch.models.anyres import CLIP_MEAN, CLIP_STD
from mllm_sparse_retrieval_tpu_torch.models.api import (
    encode_any, image_input_spec, mrope_ids_for_batch)
from mllm_sparse_retrieval_tpu_torch.models.layers import FLASH_MIN_SEQ
from mllm_sparse_retrieval_tpu_torch.models.reps import normalize
from mllm_sparse_retrieval_tpu_torch.ops.packing import (
    pack_blocks, unpack_blocks)
from mllm_sparse_retrieval_tpu_torch.ops.select import (
    candidate_topk, filtered_topk, pad_candidates, vocab_topk)
from mllm_sparse_retrieval_tpu_torch.ops.stream import (
    pipeline_dispatch, prefetch_thread)
from mllm_sparse_retrieval_tpu_torch.sparse.term_selection import (
    SelectedTerms, doc_string_vector, get_filtered_ids, quantize_weights,
    query_string_weights, text_candidate_ids)


@dataclass
class EncodeResult:
    """Encoded examples: ids, L2-normalized dense vectors and selected
    terms (token-id arrays, what ``ImpactIndex.from_selected_terms`` /
    ``search_terms`` take). The string-keyed artifact forms,
    ``sparse_vectors`` (corpus) and ``query_weights`` (queries), are built
    on first access."""

    ids: List[str] = field(default_factory=list)
    dense: Optional[np.ndarray] = None                  # [N, d] f32
    selected_terms: List[SelectedTerms] = field(default_factory=list)
    is_query: bool = False
    is_filtered: bool = False
    id_to_token: Optional[Dict[int, str]] = None
    _sparse_vectors: Optional[List[Dict[str, int]]] = None
    _query_weights: Optional[List[Dict[str, int]]] = None

    @property
    def sparse_vectors(self) -> List[Dict[str, int]]:
        """Doc string vectors (corpus jsonl form); [] on query results."""
        if self.is_query:
            return []
        if self._sparse_vectors is None:
            self._sparse_vectors = [
                doc_string_vector(t, self.id_to_token, self.is_filtered)
                for t in self.selected_terms]
        return self._sparse_vectors

    @property
    def query_weights(self) -> List[Dict[str, int]]:
        """Query string-weight dicts (query.tsv form); [] on corpus
        results."""
        if not self.is_query:
            return []
        if self._query_weights is None:
            self._query_weights = [
                query_string_weights(t, self.id_to_token, self.is_filtered)
                for t in self.selected_terms]
        return self._query_weights


def _pad_batch_examples(batch: Sequence[Example], size: int) -> List[Example]:
    """``batch`` padded to ``size`` by repeating its last example."""
    out = list(batch)
    while len(out) < size:
        out.append(batch[-1])
    return out


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
    mask, pixels, pos, fmask)`` packs (full-vocab top-k [+ expansion
    top-k], L2-normalized dense); ``spec_fn()`` is shape-static (image
    selection has no candidate set: the reference takes the top
    ``sparse_length`` vocab terms). ``pixels`` is a pixel tensor or the
    family's dict; ``pos`` the ``[3, B, T]`` M-RoPE ids (Qwen2.5-VL) or
    None."""
    hidden = arch.text.hidden_size

    @torch.inference_mode()
    def _fn(p, lora, ids, mask, pixels, pos, fmask):
        sparse, dense = encode_any(p, arch, ids, mask, pixels, reps_loc,
                                   lora, position_ids=pos)
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
    input form of the variable-token families (anyres, dynamic tiling,
    native resolution). For a file that exists it raises, as
    ``default_pixel_loader`` does."""

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


def encode_examples(
    examples: Sequence[Example],
    params,
    arch,
    tokenizer,
    template,
    *,
    encode_type: str,                  # 'text' | 'image'
    sparse_cfg,
    reps_loc: RepsLoc = RepsLoc.BEFORE_PAD,
    batch_size: int = 8,
    is_query: bool = False,
    lora=None,
    pixel_loader: Optional[Callable[[Example], np.ndarray]] = None,
    seq_pad_multiple: int = 16,
    device="cuda",
) -> EncodeResult:
    """Encode examples into dense vectors and selected terms on ``device``
    (where ``params`` live).

    Every batch has ``batch_size`` rows; the last is padded by repeating
    its last example and its pad rows are dropped by count (``valid``).
    Text prompts pad to the batch's longest, rounded up to
    ``seq_pad_multiple``; variable-token image prompts pad to the family's
    longest prompt, rounded up to 512 once it reaches ``FLASH_MIN_SEQ`` so
    that the decoder takes the flash kernel. Qwen2.5-VL image batches carry
    their M-RoPE position ids. ``is_query`` picks the string form the
    result builds on access: ``query_weights`` or ``sparse_vectors``.
    Terms are selected on the device (``make_*_ds_encode``), the only
    route the port has. ``pixel_loader(example)`` gives an image's pixels:
    CLIP-normalized ``[S, S, 3]`` for fixed-grid families, raw
    ``[H, W, 3]`` in [0, 1] for the variable ones; the default loaders make
    seeded synthetic pixels for an absent file and raise for an existing
    one.
    """
    if encode_type not in ("text", "image"):
        raise ValueError(f"encode_type must be 'text' or 'image', "
                         f"got {encode_type!r}")
    device = torch.device(device)
    vocab = tokenizer.get_vocab()
    id_to_token = {v: k for k, v in vocab.items()}
    encode_word = lambda w: tokenizer.encode(w, add_special_tokens=False)
    spec = image_input_spec(arch)

    img_fixed_len = base_img_prompt = fixed_ids = fixed_mask = None
    fixed_pos = None                   # M-RoPE ids of fixed-grid Qwen
    if encode_type == "image":
        if spec.variable:
            if pixel_loader is None:
                pixel_loader = default_raw_image_loader()
            base_img_prompt = template.image_prompt()
            img_fixed_len = len(tokenizer.encode(template.expand_image(
                base_img_prompt, spec.max_image_tokens)))
            if img_fixed_len >= FLASH_MIN_SEQ:
                img_fixed_len = -(-img_fixed_len // 512) * 512
        else:
            if pixel_loader is None:
                raw_loader = default_pixel_loader(spec.image_size)
                pixel_loader = lambda ex: spec.preprocess(raw_loader(ex))
            img_prompt = template.expand_image(template.image_prompt(),
                                               spec.num_image_tokens)
            fixed_ids, fixed_mask = tokenizer.pad_batch(
                [tokenizer.encode(img_prompt)] * batch_size,
                pad_to_multiple=seq_pad_multiple)
            if spec.needs_mrope:
                fixed_pos = mrope_ids_for_batch(arch, fixed_ids, fixed_mask)

    k_image = sparse_cfg.sparse_length if sparse_cfg.sparse_manual else 128
    # the full-vocab top-k serves both manual-mode selection and the
    # no-candidates fallback
    k_text_full = max(sparse_cfg.sparse_length if sparse_cfg.sparse_manual
                      else 0, sparse_cfg.fallback_top_k)
    exp_k = sparse_cfg.num_expanded_tokens
    fmask = None
    if exp_k > 0:
        fm = np.zeros(arch.text.vocab_size, bool)
        fm[get_filtered_ids(vocab)] = True
        fmask = torch.from_numpy(fm).to(device)
    if encode_type == "text":
        encode_fn, spec_fn = make_text_ds_encode(arch, reps_loc,
                                                 k_text_full, exp_k)
    else:
        encode_fn, spec_fn = make_image_ds_encode(arch, reps_loc, k_image,
                                                  exp_k)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def host_prep(batch):
        """Tokenization, candidates, image preprocessing of one padded
        batch (on the prefetch thread, a batch ahead of the device)."""
        if encode_type == "text":
            prompts = [template.fill_text(template.text_prompt(), ex.text)
                       for ex in batch]
            ids, mask = tokenizer.pad_batch(
                [tokenizer.encode(p) for p in prompts],
                pad_to_multiple=seq_pad_multiple)
            cand_ids, cand_mask = pad_candidates(
                [text_candidate_ids(ex.text, encode_word) for ex in batch])
            return ids, mask, cand_ids, cand_mask
        if spec.variable:
            vitems = [spec.preprocess_example(pixel_loader(ex))
                      for ex in batch]
            rows = [tokenizer.encode(template.expand_image(
                base_img_prompt, n)) for _, n in vitems]
            ids, mask = tokenizer.pad_batch(
                rows, max_len=img_fixed_len,
                pad_to_multiple=seq_pad_multiple)
            pixels = spec.batch_vision([i for i, _ in vitems])
            pos = (spec.mrope_from_batch(ids, mask, pixels)
                   if spec.mrope_from_batch else None)
            return ids, mask, pixels, pos
        pixels = np.stack([pixel_loader(ex) for ex in batch])
        return fixed_ids, fixed_mask, pixels, fixed_pos

    def produce():
        for start in range(0, len(examples), batch_size):
            raw = examples[start:start + batch_size]
            batch = _pad_batch_examples(raw, batch_size)
            yield batch, len(raw), host_prep(batch)

    def dispatch(item):
        """Enqueue one batch's program; no host sync."""
        batch, valid, host = item
        if encode_type == "text":
            ids, mask, cand_ids, cand_mask = host
            packed = encode_fn(params, lora, put(ids).long(), put(mask),
                               put(cand_ids), put(cand_mask), fmask)
            return item, packed, spec_fn(cand_ids.shape[1])
        ids, mask, pixels, pos = host
        d_px = ({k: put(v) for k, v in pixels.items()}
                if isinstance(pixels, dict) else put(pixels))
        d_pos = None if pos is None else put(pos).long()
        packed = encode_fn(params, lora, put(ids).long(), put(mask), d_px,
                           d_pos, fmask)
        return item, packed, spec_fn()

    result = EncodeResult(is_query=is_query,
                          is_filtered=sparse_cfg.is_filtered,
                          id_to_token=id_to_token)
    all_dense: List[np.ndarray] = []

    def resolve(handle):
        (batch, valid, host), packed, pk_spec = handle
        parts = unpack_blocks(packed.cpu().numpy(), pk_spec)
        if encode_type == "text":
            terms = resolve_text_ds_rows(parts, valid, host[2], host[3],
                                         sparse_cfg)
        else:
            terms = resolve_image_ds_rows(parts, valid, sparse_cfg)
        all_dense.append(np.asarray(parts[-1], np.float32)[:valid])
        for t, ex in zip(terms, batch[:valid]):
            result.ids.append(ex.text_id if encode_type == "text"
                              else ex.img_id)
            result.selected_terms.append(t)

    collections.deque(pipeline_dispatch(
        prefetch_thread(produce(), depth=2), dispatch, resolve,
        lookahead=2), maxlen=0)
    result.dense = np.concatenate(all_dense) if all_dense else \
        np.zeros((0, arch.text.hidden_size), np.float32)
    return result


def artifact_dir(base: str, model_name: str, dataset: str, encode_type: str,
                 sparse_cfg, lora: bool = False) -> str:
    """The reference's output tree: ``base/model/dataset/type/
    {filter|no_filter}/{exp}_{manual|no_manual}_{len}[_lora]``."""
    filt = "filter" if sparse_cfg.is_filtered else "no_filter"
    manual = "manual" if sparse_cfg.sparse_manual else "no_manual"
    leaf = (f"{sparse_cfg.num_expanded_tokens}_{manual}_"
            f"{sparse_cfg.sparse_length}")
    if lora:
        leaf += "_lora"
    return os.path.join(base, model_name, dataset, encode_type, filt, leaf)


def write_artifacts(result: EncodeResult, dense_dir: str, sparse_dir: str,
                    is_query: bool = False, shard_index: int = 0) -> None:
    """Write the dense pickle (numpy and a list, no tensors, so either
    package loads it) and the sparse jsonl / query.tsv."""
    os.makedirs(dense_dir, exist_ok=True)
    os.makedirs(sparse_dir, exist_ok=True)
    dense_name = "query.pkl" if is_query else f"corpus_{shard_index}.pkl"
    dense = np.asarray(result.dense, np.float32)
    with open(os.path.join(dense_dir, dense_name), "wb") as f:
        pickle.dump((dense, list(result.ids)), f)
    if is_query:
        # each token repeated weight-many times (Lucene's whitespace-count
        # form); empty queries are skipped
        with open(os.path.join(sparse_dir, "query.tsv"), "w") as f:
            for qid, weights in zip(result.ids, result.query_weights):
                q = " ".join(" ".join([tok] * w)
                             for tok, w in weights.items())
                if not q.strip():
                    continue
                f.write(f"{qid}\t{q}\n")
    else:
        with open(os.path.join(sparse_dir, f"corpus_{shard_index}.jsonl"),
                  "w") as f:
            for doc_id, vec in zip(result.ids, result.sparse_vectors):
                f.write(json.dumps(
                    {"id": doc_id, "content": "", "vector": vec}) + "\n")


def read_query_tsv(path: str) -> Dict[str, Dict[str, int]]:
    """Parse a query.tsv back into per-query term-count dicts."""
    out: Dict[str, Dict[str, int]] = {}
    with open(path) as f:
        for line in f:
            qid, _, text = line.rstrip("\n").partition("\t")
            counts: Dict[str, int] = {}
            for tok in text.split():
                counts[tok] = counts.get(tok, 0) + 1
            out[qid] = counts
    return out

#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` (one plain ``nvcc`` call
per source, all started together with the ``g++`` calls of the native
index builder and of the ``hostops`` CPython extension) and holds each
kernel against its plain PyTorch version at the shapes the port's paths
give it: the TAAT kernel at the
served and the benchmark shapes; the flash-attention forward and the dq and
dkv backward kernels on synthetic 3,072-token rows with an all-pad row
(what the kernels line reports) and on the rows of the profiled training
step, and the forward again at LLaVA-1.6-Vicuna's 32 KV heads (G = 1) and
at InternVL2.5-8B's 28 query on 4 KV heads (G = 7) on 3,584-token rows of
its image prompt lengths (the kernels line's ``at_g7``), and the dq and
dkv kernels there too, on the lengths of an InternVL2.5 training batch;
each with its bound and its share of the bf16 peak. Then it makes the
main path's model from a checkpoint: the full-width, full-depth
LLaVA-NeXT-Llama3-8B, bf16 weights drawn on the card from a seed, is
written as a Hugging Face llava_next checkpoint (bf16 safetensors shards
in the hub's key layout, kept in RAM, an index and ``config.json``),
converted by ``models.convert.convert_hf_dir`` and loaded by
``build_model``, every tensor bit-equal to the drawn one. It drives the
port's five paths end to end on that loaded model: text
queries through ``RetrievalService`` and the 32-layer text tower; image
queries through anyres preprocessing, the 24-layer ViT-L/14-336 on five
336 px tiles, the projector and the 3,072-token decoder, whose attention is
the flash kernel (both paths select terms on the device and score an impact
index of 25,010 synthetic docs with the TAAT kernel; every served result
must equal the matmul backend's on the same terms); offline evaluation, a
flickr-layout CSV of 64 seeded images and 320 captions read by
``CrossModalCorpus``, encoded by ``encode_examples`` as documents and as
queries (the image prompts take the flash kernel), written as artifacts,
indexed by both impact-index builders (layouts equal) and the dense flat
index, and searched text->image and image->text by ``run_search`` (dense,
sparse through the TAAT kernel, min-max and RRF fusion, recall: the sparse
run equal to the matmul backend's, the dense run within 1e-5 of a float64
product, recall equal to a numpy count; then the device routes, fusion on
the device and evaluation from device ranks, held to the host fuse of the
same encodings within 1e-5 and to its recall); hybrid dense + sparse
serving, a dense flat index of the impact index's 25,010 doc ids at the
model's dense width (f32, and once bf16) beside it, text and image queries
through ``RetrievalService(dense_index=..., impact_index=...)`` fused on
the device, filtered text queries, RRF and dense mode, every result held
to the host fuse (float64) of the two engines' own runs within 1e-5, with
one TAAT launch per micro-batch and the flash kernel 32 times per image
micro-batch, and the text queries served through a sparse and a hybrid
service in turns; the rest of search beside those indexes: the compact48
wire (served text, filtered, the 2^24 refusal; equal to the i32 wire),
``explain`` of served tops, pipelined streams on both wires (equal to
``search_encoded``, one TAAT launch per chunk), SQ8 int8 and ANN dense
indexes in dense and device-fused hybrid modes (exact int32 products,
scores within 1e-5 relative of float64, ANN with every candidate equal to
the exact index, candidate recall on low-rank rows), and the bf16 search's
memory bound; live indexes and the HTTP front end: arena copies of the
impact index and the dense rows served by ``cli.serve``'s boot behind the
aio server, text queries over HTTP before and after adds, replaces and
deletes over HTTP (the int16 matrix keeps its storage; the TAAT kernel on
it equals its plain version), an add past the headroom, the int16 drop,
``/compact``, ``/save`` and ``load_live_state``, the segment classes, image
documents posted by ``cli.ingest``'s helpers and ``cli.serve --live`` as a
child process, every result held to the host fuse of a static rebuild of
the live documents; and contrastive LoRA
training, a few ``ContrastiveTrainer.train_on_batch`` steps on seeded
image-caption pairs whose 3,072-token image prompts take the flash kernels
forward and backward. The whole tower is also run, and differentiated,
with the flash kernels and with plain attention, and the two compared.
Last, LLaVA-1.6-Vicuna-7B (anyres, the flash kernel at G = 1) and
LLaVA-1.5-7B (fixed 336 px grid, prompts short enough for plain
attention) are drawn at full width, one after the other, and serve 8 text
and 8 image queries each, every result equal to the matmul backend's; and
so, through their chat templates on the synthetic tokenizer with the
families' special tokens as single ids, do InternVL2.5-8B (dynamic tiling
into 13 tiles of 448 px, InternViT-300M, pixel shuffle, 3,584-token image
prompts whose decoder attention is the flash kernel at G = 7, 28 launches
per image micro-batch) and Qwen2.5-VL-7B (native-resolution
preprocessing, the windowed ViT on up to 4,608 padded patches, M-RoPE,
prompts under 1,024 tokens on plain attention), each with one image
micro-batch's breakdown; each of the two is then trained for two
``train_on_batch`` steps (InternVL2.5's 3,584-token prompts through the
flash kernels forward and backward, with the flash-vs-plain gradient
check; Qwen2.5-VL's with M-RoPE ids), and on InternVL2.5 the training and
analysis entry points run: ``cli.prepare_data`` on a Karpathy JSON,
``cli.train.run`` for one epoch (its ``lora.pkl`` loaded back) and
``term_weight_statistics`` of the trained model. The offline phase's
runs and fusion and the live segments' merge must go through ``hostops``,
whose C results are held to the Python bodies on the offline runs, which
``fusion_provenance_statistics`` also ranks.

Each phase prints one progress line with the seconds since start. The last
lines are a JSON object describing the kernels, the card's name and power
limit as ``nvidia-smi`` reports them, and ``{"ok": true, "device": ...}``.
Without a CUDA card, or without the rest of the repository beside it, the
script fails before printing any result. It imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import threading
import time

T0 = time.monotonic()
SEED = 0
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
F32_OPS_PER_S = 67e12           # H100 SXM f32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor-core rate

# benchmark shape (bench.py): Zipf terms, docs, queries of Q terms
BENCH_TERMS, N_DOCS, DOC_K, BENCH_B, BENCH_Q = 20_000, 25_010, 128, 256, 64
# served slice
VOCAB_WORDS = 20_000            # tokenizer vocabulary size
N_QUERIES, N_THREADS, MAX_BATCH, DEPTH = 32, 8, 8, 10
# a served batch takes tens of ms: these limits only make a hang fail fast
WARMUP_TIMEOUT_S, REQUEST_TIMEOUT_S, SERVE_DEADLINE_S = 60, 30, 60
STAGES = ("vision", "tower", "attention", "lm_head",
          "term_select")        # profiler ranges of encode
# flash kernel at the served image shape: 8 prompts of 3,072 tokens, 32 q-
# and 8 kv-heads of 128, compared at every query that has a real key at or
# before it (pad queries of a prompt included; an all-pad row must give
# exactly 0 on both sides). Both sides take
# bf16 and give bf16: each rounds its probabilities (the kernel unnormalised,
# the plain version normalised) and its output to bf16, unit roundoff 2^-8.
# So each element lies within FLASH_RTOL * (|ref| + sum_s p_s |v_s|) of the
# plain one (the sum is the plain version run on |v|). Independent roundings
# mostly cancel in a long sum, so the mean error stays far below that worst
# case (1.1e-4 against a mean |ref| of about 0.045 on an H100, 2^-8.6 of
# it): it must stay under FLASH_RTOL * mean |ref|.
FLASH_B, FLASH_HQ, FLASH_HKV, FLASH_DH = 8, 32, 8, 128
FLASH_RTOL = 2.0 ** -7
# served image queries: sizes that reach every LLaVA-NeXT pinpoint
IMAGE_SIZES = ((375, 500), (500, 375), (640, 640), (300, 1000), (1000, 300),
               (720, 1280), (300, 600), (600, 300))
N_IMAGES, IMAGE_THREADS = 16, 4
IMAGE_REQUEST_TIMEOUT_S, IMAGE_DEADLINE_S = 120, 240
# whole tower, flash against plain attention, on 2 images (the plain route's
# [2, 32, 3072, 3072] f32 logits fit beside the weights); bf16 through 32
# layers of random weights: the dense reps must stay this close (the H100
# gave a min cosine of 0.99989 in every run, so 1 - cos has 9x headroom)
TOWER_CHECK_B, DENSE_COS_FLOOR = 2, 0.999
# the forward's log-sum-exp against torch.logsumexp of the plain f32 logits
# (the same bf16 inputs, f32 sums in another order): within
# LSE_RTOL * (1 + |ref|), +inf where a query has no admissible key
LSE_RTOL = 1e-4
# the backward kernels at the training shape (TRAIN_B prompts of 3,072
# tokens, one all-pad). Both sides round P to bf16 before a product and each
# gradient at the end; the plain version also rounds dP to bf16, the kernels
# round dS and form di from the bf16 output. Each rounding moves a gradient
# by at most 2^-8 times the magnitudes of the terms it sums
# (FA.flash_bwd_magnitudes), di's up to twice that: every element lies
# within BWD_RTOL * (|ref| + magnitude) of the plain one, and the mean abs
# err under BWD_RTOL * mean |ref| (2^-8 of the mean magnitude where a
# gradient cancels to 0)
BWD_RTOL = 2.0 ** -6
# training: LoRA rank 8 / alpha 16 on the seven text targets, dropout 0.1,
# tau 0.05, remat, TRAIN_B image-caption pairs a step
TRAIN_B, TRAIN_STEPS, TRAIN_LR = 4, 4, 1e-4
LORA_RANK, LORA_ALPHA, LORA_DROPOUT, TAU = 8, 16, 0.1, 0.05
# whole-model gradient, flash kernels against plain attention, at B=2 and
# no dropout (after the training steps, so every adapter gradient is live):
# the cosine of the concatenated adapter gradients. bf16 through 32 layers
# forward and back; the H100 gave 0.999646, so 1 - cos has 11x headroom
GRAD_CHECK_B, GRAD_COS_FLOOR = 2, 0.996
# offline evaluation: a flickr-layout corpus of OFF_IMAGES images (the eight
# IMAGE_SIZES, all five pinpoints) with OFF_CAPS captions each, encoded at
# batch OFF_BATCH as documents and as queries, searched both ways at depth
# OFF_DEPTH. Dense scores must lie within OFF_DENSE_TOL of a float64 product
# of the same f32 vectors (the card sums 4,096 products in f32, TF32 off)
OFF_IMAGES, OFF_CAPS, OFF_BATCH, OFF_DEPTH = 64, 5, 8, 100
OFF_KS, OFF_DENSE_TOL, OFF_ALPHA = (1, 5, 10, 100), 1e-5, 0.5
# hybrid serving: a dense flat index of the impact index's N_DOCS doc ids at
# the model's dense width (4,096), f32 (and one bf16 pass); per served query
# HYB_PLANT of its sparse top-DEPTH docs get dense rows near the query's own
# dense vector, so both runs share docs. Each engine takes HYB_CAND
# candidates, fused with weight HYB_ALPHA on the dense run; fused scores
# must lie within HYB_TOL of the host fuse (float64) of the two engines'
# own runs, the JAX package's device-fusion tolerance. HYB_ALLOW_MOD: the
# filter allows the docs whose number is 0 mod it (about 10%)
HYB_CAND, HYB_ALPHA, HYB_TOL, HYB_PLANT, HYB_ALLOW_MOD = 100, 0.5, 1e-5, 3, 10
HYB_RRF_QUERIES = 8
HYB_AB_ROUNDS = 3               # text serving rounds per side, in turns
HYB_STAGES = ("impact_search", "dense_search", "fusion")
# search tiers, beside the hybrid phase's dense rows and impact index: the
# compact48 wire (sparse, filtered), streams of TIER_STREAMS batches of
# TIER_STREAM_B queries, an SQ8 int8 and an ANN dense index (rank, rescored
# candidates), explain on TIER_EXPLAIN queries. Served and returned dense
# scores must lie within TIER_REL relative of their float64 (SQ8: the
# dequantized formula) or exact-f32 counterparts, plus one f32 rounding of
# the magnitude sum_i |q_i c_i|. ANN candidate recall@DEPTH against the
# exact index on rows near a TIER_LOW_RANK-dim subspace (noise
# TIER_LOW_NOISE per element, the JAX package's ANN test construction) must
# reach TIER_RECALL_FLOOR
TIER_STREAMS, TIER_STREAM_B, TIER_EXPLAIN = 4, 64, 8
TIER_ANN_RANK, TIER_ANN_CAND, TIER_REL = 64, 1024, 1e-5
TIER_LOW_RANK, TIER_LOW_NOISE, TIER_RECALL_FLOOR = 48, 0.02, 0.95
TIER_PROFILE_ITERS = 20         # host-clock calls of each dense search
# checkpoint: the drawn LLaVA-NeXT-Llama3-8B (full width and depth) is
# written as an HF llava_next checkpoint (the hub's legacy key layout, bf16
# safetensors in shards of at most CKPT_SHARD_BYTES, with an index),
# converted by convert_hf_dir (an f32 params.pkl) and loaded by
# build_model; every loaded tensor must equal its drawn one bit for bit
# (two int64 sums of its bf16 bit patterns, the second weighted by position
# mod CHECKSUM_MOD, CHECKSUM_CHUNK elements at a time)
CKPT_SHARD_BYTES = 5 * 10 ** 9
# the converter's pickling rate apart from its disk: the f32 tree of the
# first PICKLE_SPLIT_LAYERS decoder blocks, pickled as convert_hf_dir
# pickles params.pkl, to /dev/null, to a RAM file and to a disk file
PICKLE_SPLIT_LAYERS = 4
CHECKSUM_CHUNK, CHECKSUM_MOD = 1 << 26, 8191
# families: LLaVA-1.6-Vicuna-7B (anyres, 32 KV heads: the flash forward at
# G = 1) and LLaVA-1.5-7B (fixed grid, prompts under FLASH_MIN_SEQ: plain
# attention) drawn at full width, FAM_QUERIES text and image queries each;
# the flash kernel at the Vicuna image shape has VICUNA_HEADS q / kv heads
FAM_QUERIES, VICUNA_HEADS = 8, 32
# chat-template families: InternVL2.5-8B (13 tiles x 256 = 3,328 image
# tokens, prompts padded to 3,584; 28 query / 4 KV heads: the flash
# forward at G = 7) and Qwen2.5-VL-7B (native resolution, at most 768
# merge units: prompts under FLASH_MIN_SEQ, plain attention), drawn at
# full width, FAM_QUERIES text and image queries each, through the chat
# templates on the synthetic tokenizer with the families' special tokens
# (CHAT_SPECIALS) as single ids
CHAT_SPECIALS = ("<|im_start|>", "<|im_end|>", "<|vision_start|>",
                 "<|vision_end|>", "<|image_pad|>", "<img>", "</img>",
                 "<IMG_CONTEXT>")
INTERNVL_HEADS = (28, 4)
# chat-family training: CHAT_TRAIN_STEPS train_on_batch steps of TRAIN_B
# pairs per family (LoRA, dropout and remat as in the training phase); then
# the entry points on InternVL2.5-8B: cli.prepare_data on a Karpathy JSON of
# CLI_IMAGES images (OFF_CAPS captions each; half train or restval), a
# few-shot CSV of CLI_PAIRS images, cli.train.run for one epoch on them at
# batch TRAIN_B, and term_weight_statistics of the trained model on them
CHAT_TRAIN_STEPS, CLI_IMAGES, CLI_PAIRS = 2, 32, 8
# live indexes and the HTTP front end: arena copies of the impact index and
# the hybrid phase's dense rows with the default LIVE_HEADROOM reserved
# columns and rows; LIVE_POSTS adds of LIVE_POST_DOCS new docs over HTTP
# (LIVE_PLANT of them planted on the first text queries), LIVE_REPLACE
# replaces and LIVE_DELETE deletes; one in-process add of LIVE_GROW_DOCS
# past the headroom (_grow); one add of a LIVE_BIG_WEIGHT weight (the int16
# drop); LIVE_INGEST images posted by cli.ingest's helpers. Planted docs
# carry their query's terms at LIVE_PLANT_WEIGHT. Served fused
# scores must lie within LIVE_TOL of the host fuse of a static rebuild,
# whose runs are fetched LIVE_FETCH deep to see ties at a cut. The phase
# writes its artifacts and saves (about 1.6 GB) to /dev/shm when it has
# LIVE_SCRATCH_BYTES free; the cli.serve child must be up within
# LIVE_BOOT_TIMEOUT_S
LIVE_HEADROOM, LIVE_POSTS, LIVE_POST_DOCS, LIVE_PLANT = 8192, 4, 256, 8
LIVE_REPLACE, LIVE_DELETE, LIVE_GROW_DOCS = 64, 256, 9000
LIVE_BIG_WEIGHT, LIVE_INGEST, LIVE_TOL, LIVE_FETCH = 40_000, 16, 1e-5, 64
LIVE_SCRATCH_BYTES, LIVE_BOOT_TIMEOUT_S = 4 * 10 ** 9, 300
LIVE_PLANT_WEIGHT = 1000        # above every corpus weight (1..349)


def progress(phase: str, msg: str) -> None:
    print(f"[{time.monotonic() - T0:8.2f}s] {phase}: {msg}", flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn``: ``iters`` calls captured in one CUDA graph
    and replayed, so no host issue time sits between them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def taat_bound(matrix, safe_idx, safe_w):
    """Least time the card could take for one TAAT call on these inputs:
    the distinct live rows read once, the query arrays read once, the
    output written once, against the live multiply-adds."""
    import torch

    live = (safe_idx > 0) & (safe_w != 0)
    rows = torch.unique(safe_idx[live]).numel()
    b, q = safe_idx.shape
    n = matrix.shape[1]
    nbytes = rows * n * matrix.element_size() + b * q * 8 + b * n * 4
    ops = 2 * int(live.sum()) * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by


def replay_floor_ms(iters: int = 200) -> float:
    """Device time of the smallest launch, ``zero_()`` of 8 f32 values,
    replayed as ``device_ms`` replays a kernel: the part of a tiny kernel's
    time that no kernel design removes."""
    import torch

    tiny = torch.empty(8, device=DEVICE)
    return device_ms(tiny.zero_, iters)


def check_kernel(label, matrix, safe_idx, safe_w, iters, floor=False):
    """Kernel vs plain version (must be exactly equal), their times, the
    f32 query-table matmul's time and the bound; with ``floor``, also the
    replay floor of the smallest launch."""
    import torch

    from mllm_sparse_retrieval_tpu_torch.ops import impact_kernel as K
    from mllm_sparse_retrieval_tpu_torch.ops import score_programs as SP

    got = K.impact_scores_taat(matrix, safe_idx, safe_w)
    ref = K.impact_scores_taat_plain(matrix, safe_idx, safe_w)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not torch.isfinite(got).all() or err != 0.0:
        raise AssertionError(f"{label}: kernel differs from the plain "
                             f"version (max abs err {err})")
    ms = device_ms(lambda: K.impact_scores_taat(matrix, safe_idx, safe_w),
                   iters)
    plain_ms = device_ms(
        lambda: K.impact_scores_taat_plain(matrix, safe_idx, safe_w),
        max(3, iters // 10))
    table = SP._query_table(safe_idx - 1, safe_w, matrix.shape[0])
    mat32 = matrix.float()
    with SP.full_f32_matmul():
        lib = table @ mat32
        if not torch.equal(lib, got):
            raise AssertionError(f"{label}: query-table matmul differs from "
                                 f"the kernel")
        library_ms = device_ms(lambda: torch.matmul(table, mat32),
                               max(3, iters // 10))
    del mat32, table, lib
    bound_ms, bound_by = taat_bound(matrix, safe_idx, safe_w)
    split = K.taat_split(safe_idx.shape[0], matrix.shape[1],
                         K._sm_count(matrix.device))
    floor_ms = replay_floor_ms() if floor else None
    progress("kernel", f"{label}: exact (max abs err {err}); kernel "
             f"{ms:.4f} ms (term split {split}), plain {plain_ms:.4f} ms, "
             f"f32 query-table matmul {library_ms:.4f} ms, bound "
             f"{bound_ms:.4f} ms ({bound_by})"
             + (f", replay floor of the smallest launch {floor_ms:.4f} ms"
                if floor else ""))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def zipf_p(n):
    import numpy as np

    p = 1.0 / np.arange(1, n + 1)
    return p / p.sum()


def phase_kernel_bench(rng):
    """The kernel at bench.py's shape, int16 and f32 matrices."""
    import numpy as np
    import torch

    from mllm_sparse_retrieval_tpu_torch.index import ImpactIndex
    from mllm_sparse_retrieval_tpu_torch.ops import score_programs as SP
    from mllm_sparse_retrieval_tpu_torch.ops.impact_kernel import (
        prepare_query_arrays)

    p = zipf_p(BENCH_TERMS)
    doc_terms = rng.choice(BENCH_TERMS, size=(N_DOCS, DOC_K), p=p)
    doc_weights = rng.integers(1, 350, size=(N_DOCS, DOC_K))
    q_idx = rng.choice(BENCH_TERMS, size=(BENCH_B, BENCH_Q), p=p)
    q_w = rng.integers(1, 300, size=(BENCH_B, BENCH_Q))
    index = ImpactIndex.from_packed_arrays(
        doc_terms.astype(np.int32), doc_weights.astype(np.float32),
        term_keys=range(BENCH_TERMS), device=DEVICE)
    safe_idx, safe_w = (torch.from_numpy(a).to(DEVICE)
                        for a in prepare_query_arrays(q_idx, q_w))
    out = {}
    for dtype in ("i16", "f32"):
        matrix = index._materialize(dtype)
        out[dtype] = check_kernel(
            f"bench shape {tuple(matrix.shape)} {matrix.dtype}, "
            f"B={BENCH_B} Q={BENCH_Q}", matrix, safe_idx, safe_w, iters=50)
    # peak device memory of one search chunk per byte of its [B, N_pad] f32
    # score tensor (the index's chunk budget, _SCORE_MEMORY_FACTOR)
    q_i = torch.from_numpy(q_idx.astype(np.int32)).to(DEVICE)
    q_f = torch.from_numpy(q_w.astype(np.float32)).to(DEVICE)
    # a doc filter of ~10% (its own stream: the main one stays as it was)
    mask = torch.from_numpy(np.random.default_rng(SEED + 5).random(
        index._materialize("i16").shape[1]) < 0.1).to(DEVICE)
    factors = []
    for fn, dtype in ((SP._taat_topk, "i16"), (SP._impact_topk, "f32"),
                      (lambda *a: SP._taat_topk(*a, mask), "i16")):
        matrix = index._materialize(dtype)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(matrix, q_i, q_f, N_DOCS, 1000)
        torch.cuda.synchronize()
        factors.append((torch.cuda.max_memory_allocated() - base)
                       / (BENCH_B * matrix.shape[1] * 4))
    progress("kernel", f"search chunk peak memory / score tensor: taat "
             f"{factors[0]:.3f}, matmul {factors[1]:.3f}, filtered taat "
             f"{factors[2]:.3f} (depth 1000)")
    index.drop_device_cache()
    torch.cuda.empty_cache()
    return out


def sass_counts(so):
    """Tensor-core instructions in a built library's SASS (``cuobjdump``
    beside ``nvcc``): (HGMMA, the wgmma count; HMMA, the mma.sync
    count)."""
    from mllm_sparse_retrieval_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    words = sass.split()
    return (sum(w.startswith("HGMMA.") for w in words),
            sum(w.startswith("HMMA.") for w in words))


def build_kernels():
    """Every kernel of the port, one ``nvcc`` each, all started together
    with the ``g++`` calls of the native index builder and of the
    ``hostops`` extension; prints each build's time, ``-Xptxas -v``
    register report and count of tensor-core instructions. Every flash
    kernel runs on wgmma: a flash library with an mma.sync instruction
    fails; so does a ``hostops`` that does not build and load."""
    from concurrent.futures import ThreadPoolExecutor

    from mllm_sparse_retrieval_tpu_torch import hostops
    from mllm_sparse_retrieval_tpu_torch.ops import cuda_build
    from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA
    from mllm_sparse_retrieval_tpu_torch.ops import impact_kernel as K

    from mllm_sparse_retrieval_tpu_torch.index import native

    sources = (K.SOURCE, FA.SOURCE, FA.BWD_SOURCE)
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(sources) + 2) as pool:
        # the g++ calls run beside the nvcc calls
        def timed(build):
            t = time.monotonic()
            return build(), time.monotonic() - t

        gxx = pool.submit(timed, native.build)
        hops = pool.submit(timed, hostops.build)
        results = list(pool.map(
            lambda src: cuda_build.build(src, verbose=True), sources))
        gxx_so, gxx_s = gxx.result()
        hops_so, hops_s = hops.result()
    progress("build", f"index/native/impact_builder.cc: {native.compiler()} "
             f"{' '.join(native.CXX_FLAGS)} {gxx_s:.2f}s -> {gxx_so.name}")
    loaded = hostops.get()
    if loaded.path != hops_so or sorted(hostops.FUNCTIONS) != sorted(
            n for n in dir(loaded.ext) if not n.startswith("_")):
        raise AssertionError(f"hostops: {loaded.path} loaded, "
                             f"{hops_so} built")
    progress("build", f"hostops/hostops.c: {hostops.compiler()} "
             f"{' '.join(hostops.CXX_FLAGS)} -I{hostops.include_dir()} "
             f"{hops_s:.2f}s -> {hops_so.name}; loaded, functions "
             f"{', '.join(hostops.FUNCTIONS)}")
    for src, (so, build_s, msgs) in zip(sources, results):
        regs = [ln.strip() for ln in msgs.splitlines()
                if "registers" in ln or "spill" in ln or "arning" in ln]
        hgmma, hmma = sass_counts(so)
        progress("build", f"{src}: nvcc {build_s:.2f}s -> {so.name}; "
                 + ("; ".join(regs) if regs else "already built")
                 + f"; SASS {hgmma} HGMMA, {hmma} HMMA")
        if src != K.SOURCE and (hmma or not hgmma):
            raise AssertionError(f"{src}: {hgmma} wgmma and {hmma} mma.sync "
                                 f"instructions; the flash kernels run on "
                                 f"wgmma only")
    progress("build", f"all {len(sources)} CUDA sources, the index "
             f"builder and hostops in {time.monotonic() - t0:.2f}s")


def admissible_pairs(mask) -> int:
    """(query, key) pairs the key-mask rule admits: for a right-padded row
    of ``n`` real tokens, query ``t`` sees ``min(t + 1, n)`` keys."""
    t = mask.shape[1]
    return sum(n * (n + 1) // 2 + (t - n) * n
               for n in mask.sum(dim=1).tolist())


def bound(ops, nbytes):
    """(least ms for ``ops`` bf16 tensor-core operations and ``nbytes`` of
    device memory traffic, which of the two bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by


def flash_bound(mask, hq, hkv, dh):
    """Least time the card could take for one flash forward on these
    inputs: q, k, v, out and the mask moved once, against the multiply-adds
    of the two products over the admissible pairs."""
    b, t = mask.shape
    ops = 4 * hq * dh * admissible_pairs(mask)
    nbytes = b * t * dh * 2 * (2 * hq + 2 * hkv) + b * t * 4
    return bound(ops, nbytes)


def bwd_bound(mask, hq, hkv, dh, products, out_heads):
    """Least time for one backward kernel: ``products`` 128-deep products
    per admissible pair and head (dq: S, dP, dQ; dkv: S, dP, dV, dK), q, k,
    v, dout, lse, di and the mask read once, ``out_heads`` heads of
    gradient written once."""
    b, t = mask.shape
    ops = 2 * products * hq * dh * admissible_pairs(mask)
    nbytes = (b * t * dh * 2 * (2 * hq + 2 * hkv + out_heads)
              + 2 * b * hq * t * 4 + b * t * 4)
    return bound(ops, nbytes)


def has_key(mask):
    """[B, T] bool: the query has a real key at or before it."""
    return mask.bool().cumsum(dim=1) > 0


def flash_errors(got, ref, ref_abs, mask):
    """Max and mean abs error of the kernel's output ``got`` against the
    plain version's ``ref`` at every query with a real key at or before it,
    and the share of each limit they use (see ``FLASH_RTOL``; ``ref_abs`` is
    the plain version on ``|v|``); raises past a limit, on a non-finite
    output, or unless both give exactly 0 where a query has no key."""
    import torch

    torch.cuda.synchronize()
    rows = has_key(mask)
    finite = bool(torch.isfinite(got.float()).all())
    zeros = bool((got[~rows] == 0).all()) and bool((ref[~rows] == 0).all())
    diff = (got.float() - ref.float()).abs()[rows]
    ref, ref_abs = ref.float().abs()[rows], ref_abs.float()[rows]
    # 0 / 0 where the plain output and its magnitude are both exactly 0 (a
    # query whose only key has a 0 element in v) is an exact element
    used = float((diff / (FLASH_RTOL * (ref + ref_abs))).nan_to_num_(
        nan=0.0).max())
    mean_used = float(diff.mean() / (FLASH_RTOL * ref.mean()))
    err, mean_err = float(diff.max()), float(diff.mean())
    if not finite or not zeros or used > 1 or mean_used > 1:
        raise AssertionError(
            f"flash kernel differs from the plain version: max abs err {err} "
            f"({used:.3g} of its element tolerance), mean abs err {mean_err} "
            f"({mean_used:.3g} of its limit), finite {finite}, zero rows "
            f"without a key {zeros}")
    return err, mean_err, used, mean_used


def lse_error(lse, q, k, mask):
    """Largest share of ``LSE_RTOL * (1 + |ref|)`` that the forward's
    log-sum-exp uses against ``torch.logsumexp`` of the plain f32 logits
    (one kv-head group at a time); raises unless it is within the limit and
    +inf exactly where a query has no admissible key."""
    import torch

    b, t, hq, dh = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    pos = torch.arange(t, device=q.device)
    ok = (pos[:, None] >= pos[None, :])[None, None] \
        & mask.bool()[:, None, None, :]
    rows = has_key(mask)[:, None, :].expand(-1, rep, -1)
    used, inf_ok = 0.0, True
    for g in range(hkv):
        logits = torch.einsum("btgd,bsd->bgts",
                              q[:, :, g * rep:(g + 1) * rep].float(),
                              k[:, :, g].float()) * dh ** -0.5
        ref = torch.logsumexp(logits.masked_fill_(~ok, float("-inf")), -1)
        got = lse[:, g * rep:(g + 1) * rep]
        diff = (got[rows] - ref[rows]).abs()
        used = max(used, float((diff / (LSE_RTOL * (1 + ref[rows].abs())))
                               .max()))
        inf_ok &= bool((got[~rows] == float("inf")).all())
        del logits, ref
    if not inf_ok or not used <= 1:
        raise AssertionError(f"flash log-sum-exp: {used:.3g} of its "
                             f"tolerance, +inf without a key {inf_ok}")
    return used


def allowed_mask(mask):
    """``[B, 1, T, T]`` boolean attend mask of the key-mask rule (for
    ``scaled_dot_product_attention``)."""
    import torch

    t = mask.shape[1]
    pos = torch.arange(t, device=mask.device)
    return ((pos[:, None] >= pos[None, :])[None]
            & mask.bool()[:, None, :])[:, None]


def phase_flash(lengths, seq, hq=FLASH_HQ, hkv=FLASH_HKV):
    """The flash forward kernel on one prompt a row, of ``lengths`` real
    tokens each (the served image shape, or the training step's), with
    ``hq`` query and ``hkv`` KV heads, against its plain version (compared
    at every query with a real key at or before it), its log-sum-exp, its
    time, the plain version's and that of ``scaled_dot_product_attention``
    with the same boolean mask."""
    import torch
    import torch.nn.functional as F

    from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA

    b, dh = len(lengths), FLASH_DH
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    q, k, v = (torch.randn((b, seq, h, dh), generator=gen, device=DEVICE,
                           dtype=torch.bfloat16) for h in (hq, hkv, hkv))
    mask = torch.zeros((b, seq), dtype=torch.int32, device=DEVICE)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1                              # right padding
    got = FA.flash_causal_attention(q, k, v, mask)
    ref = FA.flash_causal_attention_plain(q, k, v, mask)
    err, mean_err, used, mean_used = flash_errors(
        got, ref, FA.flash_causal_attention_plain(q, k, v.abs(), mask), mask)
    out, lse = FA.flash_causal_attention_lse(q, k, v, mask)
    if not torch.equal(out, got):
        raise AssertionError("the forward with lse differs from the one "
                             "without")
    lse_used = lse_error(lse, q, k, mask)
    del out, lse
    ms = device_ms(lambda: FA.flash_causal_attention(q, k, v, mask), 20)
    plain_ms = device_ms(
        lambda: FA.flash_causal_attention_plain(q, k, v, mask), 3)
    allowed = allowed_mask(mask)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=allowed,
                                              enable_gqa=True)

    rows = has_key(mask)
    lib_err = float((library().transpose(1, 2).float()
                     - ref.float()).abs()[rows].max())
    library_ms = device_ms(library, 5)
    bound_ms, bound_by = flash_bound(mask, hq, hkv, dh)
    progress("flash", f"B={b} T={seq} Hq={hq} Hkv={hkv} Dh={dh} bf16, real "
             f"lengths {list(lengths)}: max abs err {err:.3g}, mean abs "
             f"err {mean_err:.3g} at every query with a key, all finite, 0 "
             f"where none; largest share of the element tolerance "
             f"{used:.3f}, mean err share of its limit {mean_used:.3f}; lse "
             f"share of its limit {lse_used:.3f}; kernel {ms:.4f} ms, plain "
             f"{plain_ms:.4f} ms, SDPA (boolean mask, GQA) "
             f"{library_ms:.4f} ms (max abs err vs plain {lib_err:.3g}), "
             f"bound {bound_ms:.4f} ms ({bound_by}), share of the bf16 "
             f"peak {bound_ms / ms:.3f}")
    del q, k, v, got, ref, allowed, qh, kh, vh
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                elem_share=used, mean_share=mean_used, lse_share=lse_used)


def event_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` between two CUDA events over ``iters``
    calls (for work that a CUDA graph cannot capture, such as autograd)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def grad_errors(got, ref, mag):
    """(max abs err, mean abs err, largest share of the element limit, share
    of the mean limit) of one gradient against the plain backward's (see
    ``BWD_RTOL``)."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    used = float((diff / (BWD_RTOL * (ref.abs() + mag))).nan_to_num_(
        nan=0.0).max())
    mean_ref = max(float(ref.abs().mean()), float(mag.mean()) * 2.0 ** -8)
    return (float(diff.max()), float(diff.mean()), used,
            float(diff.mean()) / (BWD_RTOL * mean_ref))


def phase_flash_bwd(lengths, seq, hq=FLASH_HQ, hkv=FLASH_HKV):
    """The dq and dkv kernels at a training shape (one prompt a row of
    ``lengths`` real tokens, ``hq`` query and ``hkv`` KV heads) against the
    plain backward (autograd through the plain version), their times, the
    plain backward's, and the backward of ``scaled_dot_product_attention``
    with the same boolean mask (forward plus backward, minus forward)."""
    import torch
    import torch.nn.functional as F

    from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA

    b, dh = len(lengths), FLASH_DH
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    q, k, v, dout = (torch.randn((b, seq, h, dh), generator=gen,
                                 device=DEVICE, dtype=torch.bfloat16)
                     for h in (hq, hkv, hkv, hq))
    mask = torch.zeros((b, seq), dtype=torch.int32, device=DEVICE)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1
    out, lse = FA.flash_causal_attention_lse(q, k, v, mask)
    di = FA.flash_bwd_di(out, dout)
    dq = FA.flash_attention_bwd_dq(q, k, v, mask, lse, di, dout)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, mask, lse, di, dout)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(x.float()).all()) for x in (dq, dk, dv)):
        raise AssertionError("the backward kernels gave a non-finite value")
    ref = FA.flash_causal_attention_plain_bwd(q, k, v, mask, dout)
    mags = FA.flash_bwd_magnitudes(q, k, v, mask, dout)
    errs = {name: grad_errors(g, r, m) for name, g, r, m in
            zip(("dq", "dk", "dv"), (dq, dk, dv), ref, mags)}
    del ref, mags
    torch.cuda.empty_cache()
    bad = {n: e for n, e in errs.items() if not (e[2] <= 1 and e[3] <= 1)}
    if bad:
        raise AssertionError(f"backward kernels differ from the plain "
                             f"backward: {bad}")
    dq_ms = device_ms(
        lambda: FA.flash_attention_bwd_dq(q, k, v, mask, lse, di, dout), 10)
    dkv_ms = device_ms(
        lambda: FA.flash_attention_bwd_dkv(q, k, v, mask, lse, di, dout), 10)
    plain_ms = event_ms(
        lambda: FA.flash_causal_attention_plain_bwd(q, k, v, mask, dout), 2)
    allowed = allowed_mask(mask)
    qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    doh = dout.transpose(1, 2)

    def lib_fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=allowed,
                                              enable_gqa=True)

    def lib_fwd_bwd():
        torch.autograd.grad(lib_fwd(), (qh, kh, vh), doh)

    library_ms = event_ms(lib_fwd_bwd, 3) - event_ms(lib_fwd, 3)
    del allowed, qh, kh, vh
    dq_bound = bwd_bound(mask, hq, hkv, dh, 3, hq)
    dkv_bound = bwd_bound(mask, hq, hkv, dh, 4, 2 * hkv)
    whole = bwd_bound(mask, hq, hkv, dh, 5, hq + 2 * hkv)
    shares = "; ".join(f"{n} max/mean abs err {e[0]:.3g}/{e[1]:.3g}, "
                       f"element share {e[2]:.3f}, mean share {e[3]:.3f}"
                       for n, e in errs.items())
    progress("flash_bwd", f"B={b} T={seq} Hq={hq} Hkv={hkv} Dh={dh} bf16, "
             f"real lengths {list(lengths)}: {shares}; dq kernel "
             f"{dq_ms:.4f} ms (bound {dq_bound[0]:.4f} ms, {dq_bound[1]}; "
             f"share of the bf16 peak {dq_bound[0] / dq_ms:.3f}), dkv "
             f"kernel {dkv_ms:.4f} ms (bound {dkv_bound[0]:.4f} ms, "
             f"{dkv_bound[1]}; share {dkv_bound[0] / dkv_ms:.3f}); both "
             f"{dq_ms + dkv_ms:.4f} ms against a five-product bound of "
             f"{whole[0]:.4f} ms ({whole[1]}); plain "
             f"backward {plain_ms:.4f} ms; SDPA backward (boolean mask, GQA; "
             f"forward+backward minus forward) {library_ms:.4f} ms")
    del q, k, v, dout, out, lse, di, dq, dk, dv
    torch.cuda.empty_cache()
    common = dict(plain_ms=plain_ms, library_ms=library_ms)
    return (dict(max_abs_err=errs["dq"][0], ms=dq_ms, bound_ms=dq_bound[0],
                 bound_by=dq_bound[1], elem_share=errs["dq"][2],
                 mean_share=errs["dq"][3], **common),
            dict(max_abs_err=max(errs["dk"][0], errs["dv"][0]), ms=dkv_ms,
                 bound_ms=dkv_bound[0], bound_by=dkv_bound[1],
                 elem_share=max(errs["dk"][2], errs["dv"][2]),
                 mean_share=max(errs["dk"][3], errs["dv"][3]), **common))


def synthetic_lexicon(rng, n):
    """``n`` distinct lowercase pseudo-words."""
    syll = [c + v for c in "bcdfghklmnprstvwz" for v in "aeiou"]
    words, seen = [], set()
    while len(words) < n:
        k = int(rng.integers(2, 4))
        w = "".join(rng.choice(syll, size=k))
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


def captions(rng, lexicon, n, lo, hi):
    """``n`` captions of ``lo``..``hi - 1`` Zipf-drawn words (one bulk
    draw: a weighted draw per caption would rebuild the CDF each time)."""
    import numpy as np

    lens = rng.integers(lo, hi, size=n)
    words = rng.choice(len(lexicon), size=int(lens.sum()),
                       p=zipf_p(len(lexicon)))
    ends = np.cumsum(lens)
    return ["a " + " ".join(lexicon[w] for w in words[e - k:e]) + "."
            for k, e in zip(lens, ends)]


def image_key(image) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha1(np.ascontiguousarray(image, np.float32)
                        .tobytes()).hexdigest()


class RecordingEncoder:
    """Wraps an encoder and keeps the terms it selected and the dense vector
    of each text or image, and the keys of each call (one call per served
    micro-batch), so the served results can be checked on exactly what was
    served."""

    def __init__(self, encoder):
        self._enc = encoder
        self.terms = {}
        self.dense = {}
        self.calls = []
        self.tower_s = []

    def __getattr__(self, name):
        return getattr(self._enc, name)

    def _record(self, keys, dense, terms):
        self.terms.update(zip(keys, terms))
        self.dense.update(zip(keys, dense))
        self.calls.append(keys)

    def encode_texts(self, texts, pad_to=None):
        t0 = time.monotonic()
        dense, terms = self._enc.encode_texts(texts, pad_to)
        self.tower_s.append(time.monotonic() - t0)
        self._record(list(texts), dense, terms)
        return dense, terms

    def encode_images(self, images, pad_to=None):
        t0 = time.monotonic()
        dense, terms = self._enc.encode_images(images, pad_to)
        self.tower_s.append(time.monotonic() - t0)
        self._record([image_key(im) for im in images], dense, terms)
        return dense, terms


class ChatTokenizer:
    """The synthetic tokenizer with the chat-template families' special
    tokens (``CHAT_SPECIALS``) as single ids after its own vocabulary, as a
    Hugging Face tokenizer's added tokens are: the text between them goes
    through the synthetic tokenizer."""

    def __init__(self, base, specials=CHAT_SPECIALS):
        import re

        self.base = base
        self.special_ids = {t: base.vocab_size + i
                            for i, t in enumerate(specials)}
        self._split = re.compile("(" + "|".join(map(re.escape, specials))
                                 + ")")
        self.pad_id = base.pad_id

    def get_vocab(self):
        return {**self.base.get_vocab(), **self.special_ids}

    @property
    def vocab_size(self):
        return self.base.vocab_size + len(self.special_ids)

    def encode(self, text, add_special_tokens=True):
        ids = [self.base.bos_id] if add_special_tokens else []
        for part in self._split.split(text):
            if part in self.special_ids:
                ids.append(self.special_ids[part])
            elif part:
                ids.extend(self.base.encode(part, add_special_tokens=False))
        return ids

    def pad_batch(self, batch, max_len=None, pad_to_multiple=8):
        return self.base.pad_batch(batch, max_len, pad_to_multiple)


def chat_family_archs(ctok):
    """(name, arch, template) of InternVL2.5-8B and Qwen2.5-VL-7B at the
    registry's full width, their image placeholders set to ``ctok``'s ids
    (every width unchanged)."""
    import dataclasses

    from mllm_sparse_retrieval_tpu_torch.models import registry, templates

    ids = ctok.special_ids
    internvl = dataclasses.replace(registry._internvl2_5_arch(),
                                   image_token_id=ids["<IMG_CONTEXT>"])
    qwen = dataclasses.replace(
        registry._qwen2_5_vl_7b_arch(), image_token_id=ids["<|image_pad|>"],
        vision_start_token_id=ids["<|vision_start|>"])
    return (("InternVL2.5-8B", internvl, templates.INTERNVL2_5),
            ("Qwen2.5-VL-7B", qwen, templates.QWEN2_5_VL))


def internvl_prompt_lengths(ctok, arch, tmpl, sizes):
    """Unpadded InternVL2.5 image prompt lengths of images of ``sizes``
    (their tile grids as ``data.tiling.dynamic_tile`` picks them) and the
    family's padded length (the longest prompt, 13 tiles, rounded up to
    512)."""
    from mllm_sparse_retrieval_tpu_torch.data.tiling import (
        candidate_grids, closest_aspect_ratio)

    s, mx = arch.vision.image_size, arch.max_dynamic_tiles
    grids = candidate_grids(1, mx)

    def length(n_tiles):
        return len(ctok.encode(tmpl.expand_image(
            tmpl.image_prompt(), arch.num_image_tokens * n_tiles)))

    lengths = []
    for h, w in sizes:
        cols, rows = closest_aspect_ratio(w / h, grids, w, h, s)
        lengths.append(length(cols * rows + (cols * rows > 1)))
    return lengths, -(-length(mx + 1) // 512) * 512


def host_ms(fn, iters: int) -> float:
    """Mean host-clock time of ``fn`` (which ends in a device sync)."""
    fn()
    t0 = time.monotonic()
    for _ in range(iters):
        fn()
    return (time.monotonic() - t0) * 1e3 / iters


def profiled(fn, by_name=(), stages=STAGES):
    """One call of ``fn`` under ``torch.profiler``: (device ms of every
    kernel and copy it ran, their count, device ms under each of
    ``stages``, device ms of the kernels whose name contains each string of
    ``by_name``). A stage's time is that of the kernels that start inside
    the device-side spans of its ``record_function`` ranges: the flash
    kernels, launched through ctypes outside any aten op, are linked to no
    CPU-side range but run inside the ``attention`` spans."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, kernels = [], []
    names = dict.fromkeys(by_name, 0.0)
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        if getattr(evt, "is_user_annotation", False):
            if evt.name in stages:
                spans.append((evt.time_range.start, evt.time_range.end,
                              evt.name))
        else:
            ms = evt.self_device_time_total / 1e3
            kernels.append((evt.time_range.start, ms))
            for key in by_name:
                if key in evt.name:
                    names[key] += ms
    stage = dict.fromkeys(stages, 0.0)
    for start, end, name in spans:
        stage[name] += sum(ms for t, ms in kernels if start <= t < end)
    return sum(ms for _, ms in kernels), len(kernels), stage, names


def profiled_again(fn, stages=STAGES):
    """``profiled`` of a call without side effects, run once more if the
    profiler returned no device time: one run of this script on an H100
    (PR 8's tree) saw none in the text breakdown, and 180 profiles of a
    small workload in six processes right after all saw theirs."""
    out = profiled(fn, stages=stages)
    if out[0] <= 0.0:
        progress("breakdown", "the profiler returned no device time; "
                 "profiling the call again")
        out = profiled(fn, stages=stages)
    return out


def breakdown(encoder, index, q_idx, q_w, batch):
    """Where one served text micro-batch's time goes: the host clock of the
    encoder's real ``encode_texts`` call and of the TAAT search of its
    terms, and, from one profiled call of each, the device time of their
    kernels, split by stage for the encoder, and the device's busy share."""
    enc = encoder._enc
    b = len(batch)

    def encode():
        enc.encode_texts(batch, pad_to=b)

    def search():
        index.search_encoded(q_idx, q_w, DEPTH, backend="taat")

    encode_ms, search_ms = host_ms(encode, 5), host_ms(search, 20)
    e_busy, e_n, stage, _ = profiled_again(encode)
    s_busy, s_n, _, _ = profiled_again(search)
    if e_busy <= 0.0 or s_busy <= 0.0:
        raise AssertionError("the profiler saw no device time")
    stages = ", ".join(f"{k} {stage[k]:.3f} ms"
                       for k in ("tower", "lm_head", "term_select"))
    progress("breakdown", f"one {b}-query batch: encode_texts {encode_ms:.2f}"
             f" ms host clock, device {e_busy:.3f} ms in {e_n} kernels and "
             f"copies (busy share {e_busy / encode_ms:.3f}; {stages}); "
             f"search_encoded taat {search_ms:.3f} ms host clock, device "
             f"{s_busy:.4f} ms in {s_n} kernels and copies")


def image_breakdown(encoder, images, flash=True, label="", iters=2):
    """Where one served image micro-batch's time goes: the host clock of a
    real ``encode_images`` call (mean of ``iters``) and, from one profiled
    call, the device time of its ``vision``, ``tower`` (``attention``
    inside it, the flash calls: required when ``flash``), ``lm_head`` and
    ``term_select`` ranges and the device's busy share."""
    import torch

    enc = encoder._enc
    b = len(images)

    def encode():
        enc.encode_images(images, pad_to=b)

    def inputs():
        enc.image_inputs(images, b)
        torch.cuda.synchronize()

    encode_ms, inputs_ms = host_ms(encode, iters), host_ms(inputs, iters)
    busy, n, stage, _ = profiled_again(encode)
    if busy <= 0.0 or (flash and stage["attention"] <= 0.0):
        raise AssertionError("the profiler saw no device time in the flash "
                             "attention ranges")
    stages = ", ".join(f"{k} {v:.3f} ms" for k, v in stage.items())
    share = (f"; attention share of tower "
             f"{stage['attention'] / stage['tower']:.3f}" if flash else "")
    progress("breakdown", f"{label}one {b}-image batch: encode_images "
             f"{encode_ms:.2f} ms host clock, of which host preprocessing "
             f"and upload {inputs_ms:.2f} ms; device {busy:.3f} ms in {n} "
             f"kernels and copies (busy share {busy / encode_ms:.3f}; "
             f"{stages}{share})")


def serve(svc, kind, queries, n_threads, request_timeout, deadline_s,
          **extra):
    """``queries`` through ``svc.search(**{kind: q}, **extra)`` from
    ``n_threads`` client threads under one deadline: (results, latency
    seconds, wall seconds). Raises on a hang or on any client's error."""
    results, latency = [None] * len(queries), [None] * len(queries)
    errors = []

    def client(rows):
        try:
            for i in rows:
                t_req = time.monotonic()
                results[i] = svc.search(**{kind: queries[i]}, **extra,
                                        timeout=request_timeout)
                latency[i] = time.monotonic() - t_req
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, daemon=True,
                                args=(range(k, len(queries), n_threads),))
               for k in range(n_threads)]
    t_run = time.monotonic()
    deadline = t_run + deadline_s
    for th in threads:
        th.start()
    for th in threads:
        th.join(max(0.0, deadline - time.monotonic()))
    wall = time.monotonic() - t_run
    alive = sum(th.is_alive() for th in threads)
    if alive:
        answered = sum(r is not None for r in results)
        progress("slice", f"{alive} client threads still waiting after "
                 f"{deadline_s} s; {answered} of {len(queries)} {kind} "
                 f"queries answered")
        raise TimeoutError(f"the served {kind} path did not answer in time")
    if errors:
        raise errors[0]
    return results, latency, wall


def check_results(index, cmap, labels, served_terms, results):
    """Every query: >= 1 positive finite term, >= 1 hit, and the same
    (doc, score) set as the matmul backend on the same terms."""
    import numpy as np

    for q, st, row in zip(labels, served_terms, results):
        w = np.asarray(st.weights, np.float64)
        if not (w.size and np.isfinite(w).all() and (w > 0).any()):
            raise AssertionError(f"query {q} selected no usable term: {st}")
        if not row or not all(np.isfinite(s) and s > 0 for _, s in row):
            raise AssertionError(f"query {q} got no hit: {row}")
    ref_s, ref_i = index.search_terms(served_terms, DEPTH,
                                      canonical_map=cmap, backend="matmul")
    for q, row, s_row, i_row in zip(labels, results, ref_s, ref_i):
        if not same_up_to_ties(row, list(zip(i_row, s_row))):
            raise AssertionError(f"query {q}: taat {row} != matmul "
                                 f"{list(zip(i_row, s_row))}")


def tower_flash_check(encoder, params, arch, images):
    """The whole image tower on ``TOWER_CHECK_B`` images with the flash
    kernel and with plain attention: dense cosine, sparse max abs
    difference and top-128 term overlap."""
    import torch
    import torch.nn.functional as F

    from mllm_sparse_retrieval_tpu_torch.models import mllm
    from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA

    ids, mask, px, _ = encoder._enc.image_inputs(images, len(images))
    out = {}
    for flash in (True, False):
        before = FA.launch_count()
        with torch.inference_mode():
            out[flash] = mllm.encode(params, arch, ids, mask, px,
                                     allow_flash=flash)
        torch.cuda.synchronize()
        launched = FA.launch_count() - before
        if launched != (arch.text.num_layers if flash else 0):
            raise AssertionError(f"allow_flash={flash}: {launched} flash "
                                 f"launches")
        torch.cuda.empty_cache()
    (sf, df), (sp, dp) = out[True], out[False]
    cos = float(F.cosine_similarity(df.float(), dp.float(), dim=-1).min())
    sparse_err = float((sf - sp).abs().max())
    k = 128
    top_f, top_p = sf.topk(k).indices.tolist(), sp.topk(k).indices.tolist()
    overlap = min(len(set(a) & set(b)) / k for a, b in zip(top_f, top_p))
    progress("tower", f"{len(images)} images of {ids.shape[1]} tokens, flash "
             f"vs plain attention through {arch.text.num_layers} layers: "
             f"min dense cosine {cos:.5f} (floor {DENSE_COS_FLOOR}), sparse "
             f"max abs diff {sparse_err:.4g}, min top-{k} term overlap "
             f"{overlap:.3f}")
    if not cos >= DENSE_COS_FLOOR:
        raise AssertionError(f"dense cosine {cos} below {DENSE_COS_FLOOR}")


def phase_train(params, arch, tok, tmpl, lexicon, rng, seq):
    """Contrastive LoRA training on the full-width model: ``TRAIN_STEPS``
    steps of ``ContrastiveTrainer.train_on_batch`` on ``TRAIN_B`` seeded
    image-caption pairs each (image prompts of ``seq`` tokens on the flash
    route), the last one profiled. Returns the trainer, the collated
    batches and the launch counts of the run."""
    import numpy as np
    import torch

    from mllm_sparse_retrieval_tpu_torch.configs import TrainConfig
    from mllm_sparse_retrieval_tpu_torch.data.karpathy import Example
    from mllm_sparse_retrieval_tpu_torch.models import lora
    from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA
    from mllm_sparse_retrieval_tpu_torch.ops import impact_kernel as K
    from mllm_sparse_retrieval_tpu_torch.train.trainer import (
        ContrastiveTrainer, make_collator)

    n = TRAIN_B * TRAIN_STEPS
    img_rng = np.random.default_rng(SEED + 4)
    sizes = [IMAGE_SIZES[(3 * i) % len(IMAGE_SIZES)] for i in range(n)]
    raw = {f"i{i}": img_rng.integers(0, 256, size=hw + (3,), dtype=np.uint8)
           .astype(np.float32) / 255.0 for i, hw in enumerate(sizes)}
    examples = [Example(c, f"/nonexistent/train_{i}.jpg", f"t{i}", f"i{i}")
                for i, c in enumerate(captions(rng, lexicon, n, 8, 14))]
    collate = make_collator(tok, tmpl, arch,
                            pixel_loader=lambda e: raw[e.img_id])
    t0 = time.monotonic()
    batches = [collate(examples[i * TRAIN_B:(i + 1) * TRAIN_B])
               for i in range(TRAIN_STEPS)]
    collate_s = (time.monotonic() - t0) / TRAIN_STEPS
    seq = -(-seq // 16) * 16            # the collator pads to 16s
    if batches[0].image_ids.shape[1] != seq:
        raise AssertionError(f"image prompts of {batches[0].image_ids.shape}"
                             f" tokens, not {seq}")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    adapters = lora.init_lora(gen, params, arch, rank=LORA_RANK,
                              alpha=LORA_ALPHA, device=DEVICE)
    cfg = TrainConfig(learning_rate=TRAIN_LR, tau=TAU, lora_rank=LORA_RANK,
                      lora_alpha=LORA_ALPHA, lora_dropout=LORA_DROPOUT,
                      remat=True, seed=SEED)
    trainer = ContrastiveTrainer(params, arch, adapters, cfg, device=DEVICE)
    start = [x.detach().clone() for x in lora.tree_leaves(adapters)]
    layers = arch.text.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launch_count()
    K.reset_launch_count()
    steps = []
    for i, batch in enumerate(batches):
        before = {k: FA.launch_count(k) for k in FA.KERNELS}
        t_step = time.monotonic()
        if i == len(batches) - 1:
            box = {}
            busy, n_kernels, _, names = profiled(
                lambda: box.update(loss=trainer.train_on_batch(batch)),
                by_name=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
            loss = box["loss"]
        else:
            loss = trainer.train_on_batch(batch)
        torch.cuda.synchronize()
        ms = (time.monotonic() - t_step) * 1e3
        launched = {k: FA.launch_count(k) - before[k] for k in FA.KERNELS}
        if launched != {"fwd": 2 * layers, "dq": layers, "dkv": layers}:
            raise AssertionError(f"step {i}: flash launches {launched}, want "
                                 f"{2 * layers} forward (with the remat "
                                 f"recompute) and {layers} dq and dkv")
        tokens = batch.text_ids.size + batch.image_ids.size
        real = int(batch.text_mask.sum() + batch.image_mask.sum())
        steps.append((loss, ms, tokens, real))
        progress("train", f"step {i}: loss {loss:.5f}, {ms:.1f} ms host "
                 f"clock{' (profiled)' if i == len(batches) - 1 else ''}, "
                 f"{tokens / ms * 1e3:.0f} tokens/s ({real / ms * 1e3:.0f} "
                 f"real tokens/s); flash launches {launched}")
    launches = {k: FA.launch_count(k) for k in FA.KERNELS}
    taat = K.launch_count()
    peak = torch.cuda.max_memory_allocated() / 1e9
    moved = max(float((x.detach() - y).abs().max())
                for x, y in zip(lora.tree_leaves(adapters), start))
    if not all(np.isfinite(x[0]) for x in steps) or not moved > 0:
        raise AssertionError(f"training: losses {[x[0] for x in steps]}, "
                             f"adapters moved {moved}")
    if taat:
        raise AssertionError(f"training launched the TAAT kernel {taat}x")
    plain = [x[1] for x in steps[1:-1]]
    bwd_ms = names["flash_bwd_dq"] + names["flash_bwd_dkv"]
    progress("train", f"{TRAIN_STEPS} steps of {TRAIN_B} pairs (image prompts"
             f" {seq} tokens, captions {batches[0].text_ids.shape[1]}), LoRA "
             f"r={LORA_RANK} on {len(lora.tree_leaves(adapters)) // 3} "
             f"projections, dropout {LORA_DROPOUT}, remat: host collate "
             f"{collate_s * 1e3:.1f} ms per batch; steps after the first "
             f"{np.mean(plain):.1f} ms mean; peak {peak:.2f} GB; adapters "
             f"moved by up to {moved:.3g}; launches {launches}; profiled "
             f"step: device {busy:.1f} ms in {n_kernels} kernels and "
             f"copies, flash forward {names['flash_fwd']:.1f} ms, dq "
             f"{names['flash_bwd_dq']:.1f} ms, dkv "
             f"{names['flash_bwd_dkv']:.1f} ms (backward kernels "
             f"{bwd_ms / busy:.3f} of the step's device time)")
    return trainer, batches, launches


def grad_check(trainer, batch):
    """One step's adapter gradients at ``GRAD_CHECK_B`` pairs and no dropout,
    through the flash kernels and through plain attention (both with
    remat): the cosine of the concatenated gradients and the relative loss
    difference."""
    import torch
    import torch.nn.functional as F

    from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc
    from mllm_sparse_retrieval_tpu_torch.models import lora
    from mllm_sparse_retrieval_tpu_torch.models.api import encode_any
    from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA
    from mllm_sparse_retrieval_tpu_torch.train.contrastive import (
        info_nce_loss)

    b = GRAD_CHECK_B

    def put(a, dtype=None):
        return torch.from_numpy(a[:b]).to(DEVICE, dtype)

    t_ids, i_ids = put(batch.text_ids, torch.long), put(batch.image_ids,
                                                        torch.long)
    t_mask, i_mask = put(batch.text_mask), put(batch.image_mask)
    px = ({k: put(v) for k, v in batch.pixels.items()}
          if isinstance(batch.pixels, dict) else put(batch.pixels))
    pos = None if batch.image_pos_ids is None else torch.from_numpy(
        batch.image_pos_ids[:, :b]).to(DEVICE, torch.long)
    leaves = [x for x in lora.tree_leaves(trainer.adapters)
              if x.requires_grad]
    out = {}
    for flash in (True, False):
        before = FA.launch_count("dq")
        _, t_emb = encode_any(trainer.params, trainer.arch, t_ids, t_mask,
                              None, RepsLoc.BEFORE_PAD, trainer.adapters,
                              remat=True, allow_flash=flash)
        _, i_emb = encode_any(trainer.params, trainer.arch, i_ids, i_mask,
                              px, RepsLoc.BEFORE_PAD, trainer.adapters,
                              position_ids=pos, remat=True,
                              allow_flash=flash)
        loss = info_nce_loss(t_emb, i_emb, TAU)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        launched = FA.launch_count("dq") - before
        if launched != (trainer.arch.text.num_layers if flash else 0):
            raise AssertionError(f"allow_flash={flash}: {launched} dq "
                                 f"launches")
        out[flash] = (float(loss.detach()), torch.cat([
            (torch.zeros_like(x) if g is None else g).flatten().float()
            for x, g in zip(leaves, grads)]))
        del t_emb, i_emb, loss, grads
        torch.cuda.empty_cache()
    (lf, gf), (lp, gp) = out[True], out[False]
    cos = float(F.cosine_similarity(gf, gp, dim=0))
    rel = abs(lf - lp) / abs(lp)
    progress("grad", f"{b} pairs, one step's adapter gradients "
             f"({gf.numel():,} values), flash kernels vs plain attention "
             f"through {trainer.arch.text.num_layers} layers: cosine "
             f"{cos:.6f} (floor {GRAD_COS_FLOOR}), gradient norms "
             f"{float(gf.norm()):.5g} / {float(gp.norm()):.5g}, losses "
             f"{lf:.6f} / {lp:.6f} (relative difference {rel:.3g})")
    if not cos >= GRAD_COS_FLOOR:
        raise AssertionError(f"gradient cosine {cos} below {GRAD_COS_FLOOR}")


def offline_image(img_id):
    """Seeded uint8 pixels, as [H, W, 3] floats in [0, 1], of the offline
    corpus image ``img_id`` (an int string), in size IMAGE_SIZES[id % 8]."""
    import numpy as np

    i = int(img_id)
    return (np.random.default_rng(i).integers(
        0, 256, size=IMAGE_SIZES[i % len(IMAGE_SIZES)] + (3,),
        dtype=np.uint8).astype(np.float32) / 255.0)


def numpy_recall(run, get_target, ks):
    """recall@k of a run counted apart from ``eval.recall``: per query, the
    docs ordered by a stable numpy sort of their scores, the first target's
    position against each cutoff, over the run's query count."""
    import numpy as np

    hits = np.zeros(len(ks), np.int64)
    for q in run:
        entry = run[q]
        docs = entry["docs"] if "docs" in entry else entry
        if not docs:
            continue
        ids = np.array(list(docs.keys()))
        order = np.argsort(-np.array(list(docs.values()), np.float64),
                           kind="stable")
        t = get_target(q)
        targets = [str(x) for x in t] if isinstance(t, list) else [str(t)]
        pos = np.nonzero(np.isin(ids[order], targets))[0]
        if pos.size:
            hits += pos[0] < np.array(ks)
    return {k: int(h) / max(len(run), 1) for k, h in zip(ks, hits)}


def check_dense_run(run, queries, qids, corpus, doc_ids, label):
    """Every returned score within OFF_DENSE_TOL of the float64 product of
    the query and the doc, the scores those of the float64 top-depth within
    it, and every doc clearly above the cut returned. Returns the largest
    score error."""
    import numpy as np

    ref = queries.astype(np.float64) @ corpus.astype(np.float64).T
    col = {d: i for i, d in enumerate(doc_ids)}
    worst = 0.0
    for r, q in enumerate(qids):
        docs = run[q]["docs"]
        idx = np.array([col[d] for d in docs])
        got = np.array(list(docs.values()), np.float64)
        err = np.abs(got - ref[r, idx])
        top = np.sort(ref[r])[::-1][:len(docs)]
        worst = max(worst, float(err.max()))
        above = set(np.nonzero(ref[r] > top[-1] + 2 * OFF_DENSE_TOL)[0])
        if len(docs) != min(OFF_DEPTH, len(doc_ids)) or \
                err.max() > OFF_DENSE_TOL or \
                np.abs(np.sort(got)[::-1] - top).max() > OFF_DENSE_TOL or \
                not above <= set(idx.tolist()):
            raise AssertionError(f"{label}: query {q}'s dense run is not the "
                                 f"float64 top-{OFF_DEPTH} within "
                                 f"{OFF_DENSE_TOL} (max err {err.max()})")
    return worst


def host_fused_run(dense, impact, q_enc):
    """The host route's min-max fused run of one encoding of the queries,
    each query's top OFF_DEPTH fused docs (what the device route keeps)."""
    from mllm_sparse_retrieval_tpu_torch.search.fusion import fuse
    from mllm_sparse_retrieval_tpu_torch.search.runs import ArrayRun

    # one chunk of every query, the device route's product shape
    d_s, d_i = dense.search_ids(q_enc.dense, OFF_DEPTH,
                                batch_size=len(q_enc.ids))
    # the matmul backend: integer impacts score exactly as TAAT does, and
    # the reference launches no kernel inside the counted run
    s_s, s_i = impact.search(q_enc.query_weights, OFF_DEPTH,
                             backend="matmul")
    fused = fuse([ArrayRun(q_enc.ids, d_s.tolist(), d_i, scores_sorted=True),
                  ArrayRun(q_enc.ids, s_s, s_i, scores_sorted=True)],
                 [OFF_ALPHA, 1 - OFF_ALPHA])
    return {q: dict(sorted(docs.items(), key=lambda kv: -kv[1])[:OFF_DEPTH])
            for q, docs in fused.items()}


def taat_chunks(impact, n_queries):
    """The TAAT launches of one search of ``n_queries`` on ``impact``: one
    per chunk of its plan, taken just before the search (the chunk width
    depends on what the index already holds on the device)."""
    return -(-n_queries // impact._search_plan("taat", OFF_DEPTH)["max_b"])


def target_tied_at(run, get_target, k, tie):
    """True when some query has a target within ``tie`` of its k-th score
    and another doc on the other side of the cut within it too: recall@k
    there depends on the order of scores the two routes round
    differently."""
    for q, docs in run.items():
        rows = sorted(docs.items(), key=lambda kv: -kv[1])
        if len(rows) <= k:
            continue
        t = get_target(q)
        targets = {str(x) for x in t} if isinstance(t, list) else {str(t)}
        edge = rows[k - 1][1]
        if abs(rows[k][1] - edge) <= tie and any(
                d in targets and abs(s - edge) <= tie for d, s in rows):
            return True
    return False


def phase_offline(params, arch, tok, tmpl, lexicon, card):
    """The offline evaluation path on the full-width model: a flickr CSV,
    ``CrossModalCorpus``, ``encode_examples`` of the images and captions as
    documents and as queries, ``write_artifacts``, both impact-index
    builders on the jsonl (layouts equal, saved and loaded),
    ``DenseFlatIndex`` from the pickles, and ``run_search`` text->image and
    image->text (dense, sparse, min-max hybrid; RRF once) with recall.
    Returns the TAAT and flash launches of the path and the text->image
    min-max search's dense and sparse runs."""
    import pickle
    import tempfile

    import numpy as np
    import torch

    from mllm_sparse_retrieval_tpu_torch.configs import (
        SearchConfig, SparseConfig)
    from mllm_sparse_retrieval_tpu_torch.data import CrossModalCorpus
    from mllm_sparse_retrieval_tpu_torch.eval.recall import recall_at_k
    from mllm_sparse_retrieval_tpu_torch.index import (
        DenseFlatIndex, ImpactIndex)
    from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA
    from mllm_sparse_retrieval_tpu_torch.ops import impact_kernel as K
    from mllm_sparse_retrieval_tpu_torch.pipelines.encode import (
        encode_examples, write_artifacts)
    from mllm_sparse_retrieval_tpu_torch.search import engine
    from mllm_sparse_retrieval_tpu_torch.search.fusion import fuse
    from mllm_sparse_retrieval_tpu_torch.search.runs import ArrayRun

    t_phase = time.monotonic()
    rng = np.random.default_rng(SEED + 3)   # leaves the main stream alone
    sparse_cfg = SparseConfig()
    loader = lambda ex: offline_image(ex.img_id)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        os.makedirs(os.path.join(root, "flickr"))
        caps = captions(rng, lexicon, OFF_IMAGES * OFF_CAPS, 8, 14)
        with open(os.path.join(root, "flickr", "flickr_test.csv"), "w") as f:
            f.write("imgid,filename,caption,sentid\n")
            for i in range(OFF_IMAGES):
                for c in range(OFF_CAPS):
                    j = OFF_CAPS * i + c
                    f.write(f"{1000 + i},{1000 + i}.jpg,{caps[j]},{j}\n")
        corpus = CrossModalCorpus("flickr", "test", root)
        sizes = {IMAGE_SIZES[int(i) % len(IMAGE_SIZES)]
                 for i in corpus.img_id_list}
        progress("offline", f"corpus: {corpus.num_images} images of sizes "
                 f"{sorted(sizes)}, {corpus.num_texts} captions "
                 f"(CrossModalCorpus, flickr layout)")

        # ---- encode: documents and queries of both modalities -----------
        K.reset_launch_count()
        FA.reset_launch_count()
        enc, rates = {}, {}
        for kind, mode in (("image", "single"), ("text", "full")):
            for is_query in (False, True):
                examples = corpus.examples(mode)
                f0 = FA.launch_count()
                t0 = time.monotonic()
                res = encode_examples(
                    examples, params, arch, tok, tmpl, encode_type=kind,
                    sparse_cfg=sparse_cfg, batch_size=OFF_BATCH,
                    is_query=is_query, pixel_loader=loader, device=DEVICE)
                torch.cuda.synchronize()
                secs = time.monotonic() - t0
                flash = FA.launch_count() - f0
                want = (arch.text.num_layers * -(-len(examples) // OFF_BATCH)
                        if kind == "image" else 0)
                if flash != want:
                    raise AssertionError(f"{kind} encode: {flash} flash "
                                         f"launches, expected {want}")
                if res.ids != [e.img_id if kind == "image" else e.text_id
                               for e in examples] or \
                        res.dense.shape != (len(examples),
                                            arch.text.hidden_size) or \
                        not np.isfinite(res.dense).all():
                    raise AssertionError(f"{kind} encode: wrong output")
                role = "queries" if is_query else "documents"
                rates[(kind, role)] = len(examples) / secs
                write_artifacts(res, os.path.join(tmp, kind, "dense"),
                                os.path.join(tmp, kind, "sparse"),
                                is_query=is_query)
                enc[(kind, is_query)] = res
                progress("offline", f"encode_examples: {len(examples)} "
                         f"{kind} {role} in {secs:.2f} s "
                         f"({rates[(kind, role)]:.2f}/s), flash launches "
                         f"{flash} ({arch.text.num_layers} per batch of "
                         f"{OFF_BATCH})" if kind == "image" else
                         f"encode_examples: {len(examples)} {kind} {role} "
                         f"in {secs:.2f} s ({rates[(kind, role)]:.2f}/s)")

        # ---- index: native and Python builders, save/load; dense ---------
        impact, dense, build_s = {}, {}, {}
        for kind in ("image", "text"):
            jsonl = [os.path.join(tmp, kind, "sparse", "corpus_0.jsonl")]
            built = {}
            for use_native in (True, False):
                t0 = time.monotonic()
                built[use_native] = ImpactIndex.from_jsonl(
                    jsonl, use_native=use_native, device=DEVICE)
                build_s[(kind, use_native)] = time.monotonic() - t0
            nat, py = built[True], built[False]
            layout = ("doc_terms", "doc_weights", "csr_offsets", "csr_docs",
                      "csr_weights")
            if nat.term_to_idx != py.term_to_idx or \
                    nat.doc_ids != py.doc_ids or not all(
                        np.array_equal(getattr(nat, a), getattr(py, a))
                        for a in layout):
                raise AssertionError(f"{kind}: the native and the Python "
                                     f"builders' layouts differ")
            nat.save(os.path.join(tmp, kind, "index"))
            impact[kind] = ImpactIndex.load(os.path.join(tmp, kind, "index"),
                                            device=DEVICE)
            if not all(np.array_equal(getattr(impact[kind], a),
                                      getattr(nat, a)) for a in layout):
                raise AssertionError(f"{kind}: the saved index loads back "
                                     f"different")
            dense[kind] = DenseFlatIndex.load(os.path.join(tmp, kind,
                                                           "dense"),
                                              device=DEVICE)
            progress("offline", f"{kind} index: {nat.num_docs} docs, "
                     f"{nat.num_terms} terms, {int(nat.csr_offsets[-1])} "
                     f"postings; native build "
                     f"{build_s[(kind, True)]:.4f} s, Python build "
                     f"{build_s[(kind, False)]:.4f} s, layouts equal, saved "
                     f"and loaded; dense {dense[kind].size} x "
                     f"{dense[kind].dim} from the pickle")
        with open(os.path.join(tmp, "image", "dense", "query.pkl"),
                  "rb") as f:
            q_reps, q_ids = pickle.load(f)
        if q_ids != enc[("image", True)].ids or q_reps.dtype != np.float32:
            raise AssertionError("query.pkl does not hold the image queries")

        # ---- search both ways; checks ------------------------------------
        recorded = []
        real_encode = engine.encode_examples

        def recording(*a, **kw):
            res = real_encode(*a, **kw)
            recorded.append(res)
            return res

        engine.encode_examples = recording
        outs, table = {}, []
        try:
            for qtype, dtype_, rule in (("text", "image", "minmax"),
                                        ("image", "text", "minmax"),
                                        ("text", "image", "rrf")):
                mode = "full" if qtype == "text" else "single"
                tgt = (lambda qt: lambda q: corpus.get_target(q, qt))(qtype)
                t0 = time.monotonic()
                want = taat_chunks(impact[dtype_], len(corpus.examples(mode)))
                taat0, flash0 = K.launch_count(), FA.launch_count()
                out = engine.run_search(
                    corpus.examples(mode), params, arch, tok, tmpl,
                    query_type=qtype, sparse_cfg=sparse_cfg,
                    search_cfg=SearchConfig(depth=OFF_DEPTH,
                                            alpha=OFF_ALPHA),
                    dense_index=dense[dtype_], impact_index=impact[dtype_],
                    batch_size=OFF_BATCH, pixel_loader=loader,
                    get_target=tgt, ks=OFF_KS, fusion_rule=rule,
                    device=DEVICE)
                secs = time.monotonic() - t0
                taat = K.launch_count() - taat0
                flash = FA.launch_count() - flash0
                q_enc = recorded[-1]
                label = f"{qtype}->{dtype_} {rule}"
                if taat != want:
                    raise AssertionError(f"{label}: {taat} TAAT launches, "
                                         f"expected {want} (one per chunk)")
                # sparse: the matmul backend on the same encoded terms
                ref_s, ref_i = impact[dtype_].search(
                    q_enc.query_weights, OFF_DEPTH, backend="matmul")
                for q, s_row, i_row in zip(q_enc.ids, ref_s, ref_i):
                    docs = out.sparse_run[q]["docs"]
                    if not same_up_to_ties(list(docs.items()),
                                           list(zip(i_row, s_row)),
                                           OFF_DEPTH):
                        raise AssertionError(f"{label}: query {q}'s sparse "
                                             f"run differs from the matmul "
                                             f"backend's")
                # dense: a float64 product over the loaded pickles
                dense_err = check_dense_run(
                    out.dense_run, q_enc.dense, q_enc.ids,
                    np.concatenate(dense[dtype_]._chunks),
                    dense[dtype_].lookup, label)
                # recall: counted apart in numpy
                for name in ("dense", "sparse", "fusion"):
                    rec = getattr(out, f"{name}_recall").recalls
                    ref = numpy_recall(getattr(out, f"{name}_run"), tgt,
                                       OFF_KS)
                    if rec != ref:
                        raise AssertionError(f"{label} {name}: recall {rec}"
                                             f" != numpy count {ref}")
                    table.append((label, name, rec))
                outs[label] = (out, q_enc)
                progress("offline", f"run_search {label}: "
                         f"{len(q_enc.ids)} queries in {secs:.2f} s; TAAT "
                         f"launches {taat}, flash launches {flash}; sparse "
                         f"run equal to the matmul backend's, dense within "
                         f"{OFF_DENSE_TOL} of float64 (max err "
                         f"{dense_err:.3g}), recall equal to the numpy "
                         f"count")

            # ---- device fusion and device evaluation ---------------------
            for qtype, dtype_, eval_mode in (("text", "image", "host"),
                                             ("image", "text", "host"),
                                             ("image", "text", "device")):
                mode = "full" if qtype == "text" else "single"
                tgt = (lambda qt: lambda q: corpus.get_target(q, qt))(qtype)
                label = f"{qtype}->{dtype_} device" + (
                    "+eval" if eval_mode == "device" else "")
                t0 = time.monotonic()
                want = taat_chunks(impact[dtype_], len(corpus.examples(mode)))
                taat0 = K.launch_count()
                out = engine.run_search(
                    corpus.examples(mode), params, arch, tok, tmpl,
                    query_type=qtype, sparse_cfg=sparse_cfg,
                    search_cfg=SearchConfig(depth=OFF_DEPTH,
                                            alpha=OFF_ALPHA),
                    dense_index=dense[dtype_], impact_index=impact[dtype_],
                    batch_size=OFF_BATCH, pixel_loader=loader,
                    get_target=tgt, ks=OFF_KS, fusion_mode="device",
                    eval_mode=eval_mode, device=DEVICE)
                secs = time.monotonic() - t0
                taat = K.launch_count() - taat0
                if taat != want:
                    raise AssertionError(f"{label}: {taat} TAAT launches, "
                                         f"expected {want} (one per chunk)")
                host_run = host_fused_run(dense[dtype_], impact[dtype_],
                                          recorded[-1])
                host_rec = recall_at_k(host_run, tgt, OFF_KS).recalls
                if eval_mode == "host":
                    for q, docs in host_run.items():
                        got = list(out.fusion_run[q].items())
                        if not close_up_to_ties(got, list(docs.items()),
                                                HYB_TOL, OFF_DEPTH):
                            raise AssertionError(f"{label}: query {q}'s "
                                                 f"fused run differs from "
                                                 f"the host fuse")
                    what = "fused run equal to the host fuse (within " \
                        f"{HYB_TOL})"
                else:
                    if out.fusion_run:
                        raise AssertionError(f"{label}: a run was copied")
                rec = out.fusion_recall.recalls
                ks = [k for k in OFF_KS
                      if not target_tied_at(host_run, tgt, k, 2 * HYB_TOL)]
                if not ks or any(rec[k] != host_rec[k] for k in ks):
                    raise AssertionError(f"{label}: recall {rec} != host "
                                         f"recall {host_rec} at {ks}")
                if eval_mode == "device":
                    what = f"recall equal to the host recall at k={ks}"
                table.append((label, "fusion", rec))
                progress("offline", f"run_search {label}: "
                         f"{len(recorded[-1].ids)} queries in {secs:.2f} s; "
                         f"TAAT launches {taat}; {what}")
        finally:
            engine.encode_examples = real_encode
        taat_total, flash_total = K.launch_count(), FA.launch_count()

        # ---- per-leg host times for 64 queries ---------------------------
        out, q_enc = outs["text->image minmax"]
        qd, qw = q_enc.dense[:64], q_enc.query_weights[:64]
        qids = q_enc.ids[:64]
        d_ms = host_ms(lambda: dense["image"].search_ids(qd, OFF_DEPTH), 5)
        s_ms = host_ms(lambda: impact["image"].search(qw, OFF_DEPTH), 5)
        d_s, d_i = dense["image"].search_ids(qd, OFF_DEPTH)
        s_s, s_i = impact["image"].search(qw, OFF_DEPTH)
        f_ms = host_ms(lambda: fuse(
            [ArrayRun(qids, d_s.tolist(), d_i, scores_sorted=True),
             ArrayRun(qids, s_s, s_i, scores_sorted=True)],
            [OFF_ALPHA, 1 - OFF_ALPHA]), 5)
    for label, name, rec in table:
        progress("offline", f"recall {label:22s} {name:6s} "
                 + ", ".join(f"r@{k} {rec[k]:.4f}" for k in OFF_KS)
                 + " (random weights: a check, not a result)")
    progress("offline", f"per 64 text queries against {OFF_IMAGES} images "
             f"at depth {OFF_DEPTH}: dense {d_ms:.3f} ms, sparse (taat) "
             f"{s_ms:.3f} ms, min-max fusion {f_ms:.3f} ms (host clock); "
             f"encode images/s documents "
             f"{rates[('image', 'documents')]:.2f}, queries "
             f"{rates[('image', 'queries')]:.2f}; captions/s documents "
             f"{rates[('text', 'documents')]:.2f}, queries "
             f"{rates[('text', 'queries')]:.2f}; TAAT launches "
             f"{taat_total}, flash launches {flash_total}; phase "
             f"{time.monotonic() - t_phase:.2f} s; card {card}")
    return taat_total, flash_total, (out.dense_run, out.sparse_run)


def close_up_to_ties(got, want, tol, depth=DEPTH):
    """(doc, score) lists equal within ``tol``, up to docs tied at the
    depth cut: rank-wise scores within ``tol``, and every doc more than
    ``2 * tol`` above the last kept score in both, its scores within
    ``tol``."""
    if len(got) != len(want):
        return False
    gs = sorted((float(x) for _, x in got), reverse=True)
    ws = sorted((float(x) for _, x in want), reverse=True)
    if any(abs(a - b) > tol for a, b in zip(gs, ws)):
        return False
    w = {d: float(x) for d, x in want}
    cut = gs[-1] + 2 * tol if len(got) >= depth else float("-inf")
    return all(d in w and abs(w[d] - float(x)) <= tol
               for d, x in got if float(x) > cut)


def terms_dict(st, cmap):
    """SelectedTerms -> the impact index's term dict, as the service builds
    it: ids folded through the canonical map, non-positive weights
    dropped, colliding ids summed."""
    import numpy as np

    ids = np.asarray(st.token_ids, np.int64)
    w = np.asarray(st.weights, np.float64)
    ids = np.where(ids < cmap.shape[0],
                   cmap[np.minimum(ids, cmap.shape[0] - 1)], -1)
    out = {}
    for k, v in zip(ids.tolist(), w.tolist()):
        if k >= 0 and v > 0:
            out[k] = out.get(k, 0.0) + v
    return out


def host_fused_rows(dense, index, cmap, dense_rows, terms_rows, flt=None,
                    rule="minmax"):
    """The host route for one served micro-batch: each engine's own run at
    HYB_CAND on the served shapes (the batch padded to the served device
    batch as the service pads it), fused by ``search.fusion.fuse`` (or
    ``fuse_rrf``) in float64 and cut to DEPTH. Returns (fused rows of
    (doc, score), the two runs)."""
    import numpy as np

    from mllm_sparse_retrieval_tpu_torch.search.fusion import fuse, fuse_rrf

    n = len(dense_rows)
    q = np.zeros((MAX_BATCH, dense_rows[0].shape[0]), np.float32)
    q[:n] = np.stack(dense_rows)
    d_s, d_i = dense.search_ids(
        q, HYB_CAND, batch_size=MAX_BATCH,
        doc_filter=None if flt is None else flt["dense"])
    q_idx, q_w = index.encode_queries(
        [terms_dict(st, cmap) for st in terms_rows] + [{}] * (MAX_BATCH - n))
    s_s, s_i = index.search_encoded(
        q_idx, q_w, HYB_CAND, backend="taat",
        doc_filter=None if flt is None else flt["sparse"])
    runs = []
    for rows_s, rows_i in ((d_s, d_i), (s_s, s_i)):
        run = {}
        for j in range(n):
            srow = [float(x) for x in rows_s[j]]
            if srow:
                run[str(j)] = {"docs": dict(zip(rows_i[j], srow)),
                               "max_score": srow[0], "min_score": srow[-1]}
        runs.append(run)
    fused = (fuse_rrf if rule == "rrf" else fuse)(
        runs, [HYB_ALPHA, 1.0 - HYB_ALPHA])
    return [sorted(fused.get(str(j), {}).items(), key=lambda kv: -kv[1])
            [:DEPTH] for j in range(n)], runs


def check_hybrid(label, enc, keys, results, dense, index, cmap, flt=None,
                 allowed=None, rule="minmax", tol=HYB_TOL):
    """Every served result of ``keys`` against the host route on exactly
    the terms and dense vector served, per served micro-batch (one encoder
    call each). Unfiltered min-max: at least one query of every batch must
    fuse a doc that both runs found. Filtered: every doc allowed."""
    by_key = dict(zip(keys, results))
    batches = 0
    for call in enc.calls:
        want, runs = host_fused_rows(dense, index, cmap,
                                     [enc.dense[k] for k in call],
                                     [enc.terms[k] for k in call], flt, rule)
        both = False
        for j, k in enumerate(call):
            got = by_key[k]
            if not got or not close_up_to_ties(got, want[j], tol):
                raise AssertionError(f"{label}: query {j} of a batch: "
                                     f"served {got} != host {want[j]}")
            if allowed is not None and not {d for d, _ in got} <= allowed:
                raise AssertionError(f"{label}: a filtered query got a "
                                     f"doc the filter excludes")
            d_docs = runs[0].get(str(j), {}).get("docs", {})
            s_docs = runs[1].get(str(j), {}).get("docs", {})
            both |= any(d in d_docs and d in s_docs for d, _ in got)
        if flt is None and rule == "minmax" and not both:
            raise AssertionError(f"{label}: no query of a batch fused a doc "
                                 f"found by both runs")
        batches += 1
    return batches


def check_filtered_legs(enc, index, cmap, flt, allowed_cols):
    """Each filtered sparse leg (the filtered TAAT top-k) against the
    unfiltered kernel scores of the allowed docs: the same scores exactly
    (integer impacts), every doc allowed."""
    import numpy as np
    import torch

    from mllm_sparse_retrieval_tpu_torch.ops import score_programs as SP

    matrix = index._materialize("i16")
    pos = {d: i for i, d in enumerate(index.doc_ids)}
    for call in enc.calls:
        terms = [enc.terms[k] for k in call]
        q_idx, q_w = index.encode_query_terms(terms, cmap)
        leg_s, leg_i = index.search_encoded(q_idx, q_w, HYB_CAND,
                                            backend="taat", doc_filter=flt)
        full = SP._taat_scores(
            matrix, torch.from_numpy(q_idx).to(DEVICE),
            torch.from_numpy(q_w).to(DEVICE))[:, :len(index.doc_ids)]
        full = full.cpu().numpy()
        for j in range(len(call)):
            cols = np.array([pos[d] for d in leg_i[j]], np.int64)
            ref = full[j, allowed_cols]
            ref = np.sort(ref[ref > 0])[::-1][:HYB_CAND]
            if not (np.isin(cols, allowed_cols).all()
                    and np.array_equal(full[j, cols], np.array(leg_s[j],
                                                                np.float32))
                    and np.array_equal(np.array(leg_s[j], np.float32), ref)):
                raise AssertionError("a filtered sparse leg differs from "
                                     "the unfiltered scores of the allowed "
                                     "docs")


def hybrid_breakdown(dense, index, cmap, enc):
    """Where one served hybrid text micro-batch's search time goes: the
    host clock of ``FusedHybridSearcher.search_encoded`` on the first
    served batch and, from one profiled call, the device time of its
    ``impact_search`` (TAAT scoring and top-k), ``dense_search`` (MIPS and
    top-k) and ``fusion`` ranges and the device's busy share."""
    import numpy as np

    from mllm_sparse_retrieval_tpu_torch.search.device_fusion import (
        FusedHybridSearcher)

    call = enc.calls[0]
    q = np.zeros((MAX_BATCH, enc.dense[call[0]].shape[0]), np.float32)
    q[:len(call)] = np.stack([enc.dense[k] for k in call])
    q_idx, q_w = index.encode_query_terms(
        [enc.terms[k] for k in call]
        + [enc.terms[call[0]]] * (MAX_BATCH - len(call)), cmap)
    fused = FusedHybridSearcher(dense, index, alpha=HYB_ALPHA,
                                backend="taat")

    def search():
        fused.search_encoded(q, q_idx, q_w, HYB_CAND, out_depth=DEPTH)

    ms = host_ms(search, 20)
    busy, n, stage, _ = profiled_again(search, stages=HYB_STAGES)
    if busy <= 0.0 or min(stage.values()) <= 0.0:
        raise AssertionError(f"the profiler saw no device time in a hybrid "
                             f"range: {stage}")
    progress("hybrid", f"breakdown of one {MAX_BATCH}-query hybrid search "
             f"(candidate depth {HYB_CAND}, out depth {DEPTH}): "
             f"{ms:.3f} ms host clock, device {busy:.4f} ms in {n} kernels "
             f"and copies (busy share {busy / ms:.3f}; "
             + ", ".join(f"{k} {v:.4f} ms" for k, v in stage.items()) + ")")


def latency_line(lat_s, n, wall):
    import numpy as np

    ms = np.array(lat_s) * 1e3
    return (f"p50 {np.percentile(ms, 50):.2f} ms, p99 "
            f"{np.percentile(ms, 99):.2f} ms, {n / wall:.2f} QPS")


def alternating_rounds(make_service, run, texts):
    """The text queries served in turns through each service of
    ``make_service`` (sparse, hybrid, hybrid, sparse, ... HYB_AB_ROUNDS
    times each, so neither side always runs first), every service built and
    warmed once: the medians of each side's p50, p99 and QPS. Host clocks
    of single runs spread widely; the medians of turns on one card are the
    comparison. Returns the TAAT launches of the rounds."""
    import numpy as np

    svcs = {name: make() for name, make in make_service.items()}
    names = list(svcs)
    order = [names[(r + (r // 2)) % 2] for r in range(2 * HYB_AB_ROUNDS)]
    stats = {name: [] for name in names}
    taat = 0
    try:
        for svc in svcs.values():
            svc.search(text=texts[0], timeout=WARMUP_TIMEOUT_S)
        for name in order:
            _, lat, wall, n_taat, _, batches = run(
                svcs[name], "text", texts, N_THREADS, REQUEST_TIMEOUT_S,
                SERVE_DEADLINE_S)
            if n_taat != batches:
                raise AssertionError(f"{name} round: {n_taat} TAAT launches "
                                     f"in {batches} micro-batches")
            taat += n_taat
            ms = np.array(lat) * 1e3
            stats[name].append((np.percentile(ms, 50), np.percentile(ms, 99),
                                len(texts) / wall))
    finally:
        for svc in svcs.values():
            svc.close()
    med = {name: np.median(np.array(v), axis=0) for name, v in stats.items()}
    progress("hybrid", f"text serving in turns ({' '.join(order)}), "
             f"medians: " + "; ".join(
                 f"{name} p50 {m[0]:.2f} ms, p99 {m[1]:.2f} ms, "
                 f"{m[2]:.2f} QPS" for name, m in med.items())
             + "; QPS of each round: " + "; ".join(
                 f"{name} " + ", ".join(f"{x[2]:.1f}" for x in v)
                 for name, v in stats.items()))
    return taat


def phase_hybrid(params, arch, arch_img, tok, tmpl, index, cmap, texts,
                 images, sparse_lines, card):
    """Hybrid dense + sparse serving on the full-width model: a dense flat
    index of the impact index's doc ids at the model's dense width, text
    and image queries through ``RetrievalService(dense_index=...,
    impact_index=...)`` (device-fused min-max), filtered requests and RRF
    (host fusion), dense mode and a bf16 dense index, each served result
    held to the host fuse of the two engines' own runs. Returns the TAAT
    and flash launches of the served runs."""
    import numpy as np
    import torch

    from mllm_sparse_retrieval_tpu_torch.configs import SparseConfig
    from mllm_sparse_retrieval_tpu_torch.index import (
        DenseFlatIndex, DocFilter)
    from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA
    from mllm_sparse_retrieval_tpu_torch.ops import impact_kernel as K
    from mllm_sparse_retrieval_tpu_torch.serving import (
        OnlineQueryEncoder, RetrievalService)

    t_phase = time.monotonic()
    base_gb = torch.cuda.memory_allocated() / 1e9
    sparse_cfg = SparseConfig()
    txt_enc = RecordingEncoder(OnlineQueryEncoder(
        params, arch, tok, tmpl, sparse_cfg, max_text_len=64,
        device=DEVICE))
    img_enc = RecordingEncoder(OnlineQueryEncoder(
        params, arch_img, tok, tmpl, sparse_cfg, device=DEVICE))

    # ---- query vectors (one direct encode), then the dense index ---------
    q_dense, q_terms = [], []
    for enc, items, fn in ((txt_enc, texts, "encode_texts"),
                           (img_enc, images, "encode_images")):
        for i in range(0, len(items), MAX_BATCH):
            d, t = getattr(enc._enc, fn)(items[i:i + MAX_BATCH],
                                         pad_to=MAX_BATCH)
            q_dense += list(d)
            q_terms += t
    dim = q_dense[0].shape[0]
    rng = np.random.default_rng(SEED + 4)
    vecs = rng.standard_normal((N_DOCS, dim), dtype=np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    _, top_ids = index.search_terms(q_terms, DEPTH, canonical_map=cmap,
                                    backend="taat")
    pos = {d: i for i, d in enumerate(index.doc_ids)}
    planted = 0
    for qv, ids in zip(q_dense, top_ids):
        u = qv / np.linalg.norm(qv)
        for d in ids[:HYB_PLANT]:
            g = rng.standard_normal(dim).astype(np.float32)
            v = u + 0.3 * g / np.linalg.norm(g)
            vecs[pos[d]] = v / np.linalg.norm(v)
            planted += 1
    order = rng.permutation(N_DOCS)
    dense = DenseFlatIndex(dim=dim, device=DEVICE)
    dense.add(vecs[order], [index.doc_ids[i] for i in order])
    dense_bf16 = DenseFlatIndex(dim=dim, dtype=torch.bfloat16, device=DEVICE)
    dense_bf16.add(vecs[order], [index.doc_ids[i] for i in order])
    del vecs
    dense._materialize()
    dense_bf16._materialize()
    torch.cuda.synchronize()
    allow_ids = index.doc_ids[::HYB_ALLOW_MOD]
    allowed = set(allow_ids)
    allowed_cols = np.arange(0, N_DOCS, HYB_ALLOW_MOD)
    progress("hybrid", f"dense index: {dense.size} docs x {dim} f32 "
             f"({dense._corpus_dev.numel() * 4 / 1e9:.3f} GB on the card) "
             f"and bf16, the impact index's doc ids in another order; "
             f"{planted} dense rows planted near {len(q_dense)} queries' "
             f"vectors (from one direct encode), {HYB_PLANT} of each "
             f"query's sparse top-{DEPTH}; filter of {len(allow_ids)} docs; "
             f"{base_gb:.2f} GB allocated before the dense indexes, "
             f"{torch.cuda.memory_allocated() / 1e9:.2f} GB after")

    def run(svc, kind, queries, threads, timeout, deadline, **extra):
        K.reset_launch_count()
        FA.reset_launch_count()
        b0 = svc.stats()["batches"]
        res, lat, wall = serve(svc, kind, queries, threads, timeout,
                               deadline, **extra)
        return (res, lat, wall, K.launch_count(), FA.launch_count(),
                svc.stats()["batches"] - b0)

    def hybrid_service(dense_index, enc, **kw):
        return RetrievalService(
            dense_index, index, query_encoder=enc, backend="taat",
            alpha=HYB_ALPHA, candidate_depth=HYB_CAND, max_batch=MAX_BATCH,
            device_batch=MAX_BATCH, depth_levels=(DEPTH,), max_wait_ms=10.0,
            **kw)

    taat_total = flash_total = 0
    # ---- text: device-fused, then filtered ---------------------------------
    svc = hybrid_service(dense, txt_enc, filters={"tenth": allow_ids})
    try:
        svc.search(text=texts[0], timeout=WARMUP_TIMEOUT_S)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        txt_enc.calls.clear()
        res, lat, wall, taat, flash, batches = run(
            svc, "text", texts, N_THREADS, REQUEST_TIMEOUT_S,
            SERVE_DEADLINE_S)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        calls = list(txt_enc.calls)
        txt_enc.calls.clear()
        f_res, f_lat, f_wall, f_taat, f_flash, f_batches = run(
            svc, "text", texts, N_THREADS, REQUEST_TIMEOUT_S,
            SERVE_DEADLINE_S, filter="tenth")
        f_calls = list(txt_enc.calls)
    finally:
        svc.close()
    taat_total += taat + f_taat
    flash_total += flash + f_flash
    progress("hybrid", f"served {len(texts)} text queries from {N_THREADS} "
             f"threads in {batches} micro-batches, device-fused: "
             f"{latency_line(lat, len(texts), wall)} (sparse text phase: "
             f"{sparse_lines['text']}); TAAT launches {taat}, flash "
             f"{flash}; peak {peak_gb:.2f} GB; card {card}")
    progress("hybrid", f"served {len(texts)} filtered text queries in "
             f"{f_batches} micro-batches, host-fused: "
             f"{latency_line(f_lat, len(texts), f_wall)}; TAAT launches "
             f"{f_taat}")
    if taat != batches or f_taat != f_batches or flash or f_flash:
        raise AssertionError(f"hybrid text: TAAT launches {taat} in "
                             f"{batches} batches, filtered {f_taat} in "
                             f"{f_batches}; flash {flash + f_flash}")
    txt_enc.calls[:] = calls
    n_b = check_hybrid("hybrid text", txt_enc, texts, res, dense, index,
                       cmap)
    txt_enc.calls[:] = f_calls
    flt = {"dense": DocFilter.from_ids(dense.lookup, allow_ids),
           "sparse": DocFilter.from_ids(index.doc_ids, allow_ids)}
    check_hybrid("filtered hybrid text", txt_enc, texts, f_res, dense,
                 index, cmap, flt=flt, allowed=allowed)
    check_filtered_legs(txt_enc, index, cmap, flt["sparse"], allowed_cols)
    progress("hybrid", f"all {len(texts)} device-fused results equal the "
             f"host fuse of the two engines' runs (within {HYB_TOL}, "
             f"{n_b} batches, each with a doc found by both runs); all "
             f"{len(texts)} filtered results equal the host fuse of the "
             f"filtered runs, every doc allowed, every sparse leg equal to "
             f"the unfiltered kernel scores of the allowed docs")
    hybrid_breakdown(dense, index, cmap, txt_enc)

    # ---- sparse and hybrid text serving in turns (one host, one card) -----
    ab_taat = alternating_rounds(
        {"sparse": lambda: hybrid_service(None, txt_enc),
         "hybrid": lambda: hybrid_service(dense, txt_enc)},
        run, texts)
    taat_total += ab_taat

    # ---- RRF, bf16 dense, dense mode --------------------------------------
    rrf_q = texts[:HYB_RRF_QUERIES]
    svc = hybrid_service(dense, txt_enc, fusion_rule="rrf")
    try:
        txt_enc.calls.clear()
        r_res, _, _, r_taat, _, r_batches = run(
            svc, "text", rrf_q, N_THREADS, REQUEST_TIMEOUT_S,
            SERVE_DEADLINE_S)
    finally:
        svc.close()
    check_hybrid("rrf hybrid text", txt_enc, rrf_q, r_res, dense, index,
                 cmap, rule="rrf", tol=1e-12)
    svc = hybrid_service(dense_bf16, txt_enc)
    try:
        txt_enc.calls.clear()
        h_res, _, _, h_taat, _, h_batches = run(
            svc, "text", texts, N_THREADS, REQUEST_TIMEOUT_S,
            SERVE_DEADLINE_S)
    finally:
        svc.close()
    check_hybrid("hybrid text, bf16 dense index", txt_enc, texts, h_res,
                 dense_bf16, index, cmap)
    taat_total += r_taat + h_taat
    if r_taat != r_batches or h_taat != h_batches:
        raise AssertionError("rrf / bf16 hybrid: TAAT launches differ from "
                             "the micro-batches")
    svc = RetrievalService(dense_index=dense, max_batch=MAX_BATCH,
                           depth_levels=(DEPTH,), max_wait_ms=10.0)
    text_vecs = q_dense[:len(texts)]
    try:
        d_res, d_lat, d_wall, d_taat, _, _ = run(
            svc, "dense", text_vecs, N_THREADS, REQUEST_TIMEOUT_S,
            SERVE_DEADLINE_S)
    finally:
        svc.close()
    ref_s, ref_i = dense.search_ids(np.stack(text_vecs), DEPTH,
                                    batch_size=MAX_BATCH)
    for j, (got, s_row, i_row) in enumerate(zip(d_res, ref_s, ref_i)):
        if not close_up_to_ties(got, list(zip(i_row, s_row)), HYB_TOL):
            raise AssertionError(f"dense mode: query {j} differs from "
                                 f"search_ids")
    if d_taat:
        raise AssertionError("dense mode launched the TAAT kernel")
    progress("hybrid", f"RRF: {len(rrf_q)} queries equal fuse_rrf of the "
             f"same runs; bf16 dense index: {len(texts)} device-fused "
             f"results equal the host fuse; dense mode: {len(texts)} "
             f"results equal search_ids "
             f"({latency_line(d_lat, len(texts), d_wall)})")

    # ---- images ------------------------------------------------------------
    svc = hybrid_service(dense, img_enc)
    try:
        svc.search(image=images[0], timeout=IMAGE_REQUEST_TIMEOUT_S)
        torch.cuda.synchronize()
        img_enc.calls.clear()
        i_res, i_lat, i_wall, i_taat, i_flash, i_batches = run(
            svc, "image", images, IMAGE_THREADS, IMAGE_REQUEST_TIMEOUT_S,
            IMAGE_DEADLINE_S)
    finally:
        svc.close()
    taat_total += i_taat
    flash_total += i_flash
    progress("hybrid", f"served {len(images)} image queries from "
             f"{IMAGE_THREADS} threads in {i_batches} micro-batches, "
             f"device-fused: {latency_line(i_lat, len(images), i_wall)} "
             f"(sparse image phase: {sparse_lines['image']}); TAAT launches "
             f"{i_taat}, flash {i_flash}; card {card}")
    if i_taat != i_batches or i_flash != arch_img.text.num_layers * i_batches:
        raise AssertionError(f"hybrid image: TAAT {i_taat}, flash {i_flash} "
                             f"in {i_batches} micro-batches")
    n_b = check_hybrid("hybrid image", img_enc,
                       [image_key(im) for im in images], i_res, dense, index,
                       cmap)
    progress("hybrid", f"all {len(images)} image results equal the host "
             f"fuse ({n_b} batches, each with a doc found by both runs); "
             f"phase {time.monotonic() - t_phase:.2f} s")
    rows, lookup = dense._host_corpus(), list(dense.lookup)
    del dense, dense_bf16
    torch.cuda.empty_cache()
    return taat_total, flash_total, (rows, lookup, text_vecs)


def dense_scores_ok(q, rows, got, ref_fn, label):
    """Every returned (doc positions, scores) row of each query within
    TIER_REL relative of ``ref_fn(query, positions)`` (float64), plus one
    f32 rounding of the magnitude sum_i |q_i c_i|."""
    import numpy as np

    for r, (pos, scores) in enumerate(got):
        pos = np.asarray(pos, np.int64)
        ref = ref_fn(r, pos)
        mag = np.abs(rows[pos].astype(np.float64)) @ np.abs(
            q[r].astype(np.float64))
        err = np.abs(np.asarray(scores, np.float64) - ref)
        if not (err <= TIER_REL * np.abs(ref) + 2.0 ** -24 * mag).all():
            raise AssertionError(f"{label}: query {r} scores off by "
                                 f"{err.max():.3e} (scores {scores})")


def low_rank_rows(rng, n, d):
    """Rows near a TIER_LOW_RANK-dim subspace (the JAX package's ANN test
    construction, at the model's dense width)."""
    import numpy as np

    basis = np.linalg.qr(rng.standard_normal((d, TIER_LOW_RANK)))[0]
    u = rng.standard_normal((n, TIER_LOW_RANK))
    return (u @ basis.T + TIER_LOW_NOISE * rng.standard_normal((n, d))
            ).astype(np.float32)


def phase_tiers(params, arch, tok, tmpl, lexicon, index, cmap, texts, host,
                card):
    """The rest of search on the full-width text tower, beside the hybrid
    phase's dense rows and impact index: the compact48 wire (served text,
    filtered, and its 2^24 refusal), ``explain`` on served tops, pipelined
    streams on both wires, SQ8 and ANN dense tiers in dense and
    device-fused hybrid modes, and the bf16 search's memory bound; every
    result held to its exact counterpart. Returns the TAAT launches of the
    served and streamed runs."""
    import numpy as np
    import torch

    from mllm_sparse_retrieval_tpu_torch.configs import SparseConfig
    from mllm_sparse_retrieval_tpu_torch.index import (
        DenseANNIndex, DenseFlatIndex)
    from mllm_sparse_retrieval_tpu_torch.ops import impact_kernel as K
    from mllm_sparse_retrieval_tpu_torch.ops import mips
    from mllm_sparse_retrieval_tpu_torch.ops.ann import (
        ann_topk_packed, ip_projection)
    from mllm_sparse_retrieval_tpu_torch.ops.packing import pack_topk
    from mllm_sparse_retrieval_tpu_torch.ops.score_programs import (
        full_f32_matmul)
    from mllm_sparse_retrieval_tpu_torch.serving import (
        OnlineQueryEncoder, RetrievalService)

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    rows, lookup, text_vecs = host
    n, dim = rows.shape
    pos = {d: i for i, d in enumerate(lookup)}
    txt_enc = RecordingEncoder(OnlineQueryEncoder(
        params, arch, tok, tmpl, SparseConfig(), max_text_len=64,
        device=DEVICE))
    allow_ids = index.doc_ids[::HYB_ALLOW_MOD]
    lines, taat_total = {}, 0

    def served(label, make, kind, queries, taat_per_batch, **extra):
        """``queries`` through a fresh service, warmed up once: the
        results; holds the TAAT launches to ``taat_per_batch`` per
        micro-batch and keeps the latency line."""
        nonlocal taat_total
        svc = make()
        try:
            svc.search(**{kind: queries[0]}, **extra,
                       timeout=WARMUP_TIMEOUT_S)
            torch.cuda.synchronize()
            txt_enc.calls.clear()
            K.reset_launch_count()
            b0 = svc.stats()["batches"]
            res, lat, wall = serve(svc, kind, queries, N_THREADS,
                                   REQUEST_TIMEOUT_S, SERVE_DEADLINE_S,
                                   **extra)
            taat, batches = K.launch_count(), svc.stats()["batches"] - b0
        finally:
            svc.close()
        if taat != taat_per_batch * batches:
            raise AssertionError(f"{label}: {taat} TAAT launches in "
                                 f"{batches} micro-batches")
        taat_total += taat
        lines[label] = latency_line(lat, len(queries), wall)
        return res

    def sparse_service(wire):
        return lambda: RetrievalService(
            impact_index=index, query_encoder=txt_enc, backend="taat",
            wire=wire, max_batch=MAX_BATCH, device_batch=MAX_BATCH,
            depth_levels=(DEPTH,), max_wait_ms=10.0,
            filters={"tenth": allow_ids})

    # ---- compact48 wire: served text, then a filtered share ----------------
    results, terms = {}, {}
    for wire in ("i32", "compact48"):
        for flt in (None, "tenth"):
            label = f"sparse {wire}" + (" filtered" if flt else "")
            extra = {} if flt is None else {"filter": flt}
            results[label] = served(label, sparse_service(wire), "text",
                                    texts, 1, **extra)
            terms[label] = {q: txt_enc.terms[q] for q in texts}
    allowed = set(allow_ids)
    for flt in ("", " filtered"):
        i32, c48 = f"sparse i32{flt}", f"sparse compact48{flt}"
        for q, a, b in zip(texts, results[i32], results[c48]):
            ta, tb = terms[i32][q], terms[c48][q]
            if not (np.array_equal(ta.token_ids, tb.token_ids)
                    and np.array_equal(ta.weights, tb.weights)):
                raise AssertionError(f"{c48}: the encoder selected other "
                                     f"terms for {q!r} than in the i32 run")
            if not (sorted(s for _, s in a) == sorted(s for _, s in b)
                    and same_up_to_ties(b, a)):
                raise AssertionError(f"{c48}: {q!r} got {b}, the i32 wire "
                                     f"{a}")
            if flt and not {d for d, _ in b} <= allowed:
                raise AssertionError(f"{c48}: a doc the filter excludes")
    check_results(index, cmap, [repr(q) for q in texts],
                  [terms["sparse compact48"][q] for q in texts],
                  results["sparse compact48"])
    q_idx, q_w = index.encode_query_terms(
        [terms["sparse compact48"][q] for q in texts[:MAX_BATCH]], cmap)
    top_w = float(index.doc_weights.max())
    live = max(int((q_w > 0).sum(axis=1).min()), 1)
    big = np.where(q_w > 0, np.ceil(2.0 ** 24 / top_w / live) + 1,
                   0).astype(np.float32)
    try:
        index.search_encoded(q_idx, big, DEPTH, backend="taat",
                             wire="compact48")
    except ValueError as e:
        if "2^24" not in str(e):
            raise
    else:
        raise AssertionError("compact48 served a batch whose score bound "
                             "reaches 2^24")
    progress("tiers", f"compact48: {len(texts)} text queries and "
             f"{len(texts)} filtered ones served on each wire, one TAAT "
             f"launch per micro-batch, results equal to the i32 wire's "
             f"(scores exactly, ties at the cut apart) and to the matmul "
             f"backend; a batch bounded at "
             f"{float(big.sum(axis=1).max()) * top_w:.4g} >= 2^24 refused; "
             + "; ".join(f"{k} {v}" for k, v in lines.items())
             + f"; card {card}")

    # ---- explain on the served tops ----------------------------------------
    for q, row in list(zip(texts, results["sparse compact48"]))[
            :TIER_EXPLAIN]:
        doc, score = row[0]
        ex = index.explain(terms_dict(terms["sparse compact48"][q], cmap),
                           doc)
        if ex["score"] != score:
            raise AssertionError(f"explain {q!r}: {ex['score']} != served "
                                 f"{score}")

    # ---- streams: TIER_STREAMS batches of TIER_STREAM_B queries ------------
    stream_texts = captions(np.random.default_rng(SEED + 5), lexicon,
                            TIER_STREAMS * TIER_STREAM_B, 10, 15)
    batches = []
    for i in range(TIER_STREAMS):
        chunk = stream_texts[i * TIER_STREAM_B:(i + 1) * TIER_STREAM_B]
        _, st = txt_enc._enc.encode_texts(chunk, pad_to=TIER_STREAM_B)
        batches.append(index.encode_query_terms(st, cmap))
    chunks = TIER_STREAMS * -(-TIER_STREAM_B // index._search_plan(
        "taat", DEPTH)["max_b"])
    stream_ms = {}
    for wire in ("i32", "compact48"):
        want = [index.search_encoded(qi, qw, DEPTH, backend="taat",
                                     wire=wire) for qi, qw in batches]
        torch.cuda.synchronize()
        K.reset_launch_count()
        t0 = time.monotonic()
        got = list(index.search_encoded_stream(iter(batches), DEPTH,
                                               backend="taat", wire=wire))
        stream_ms[wire] = (time.monotonic() - t0) * 1e3
        launches = K.launch_count()
        if launches != chunks or len(got) != TIER_STREAMS:
            raise AssertionError(f"stream {wire}: {launches} TAAT launches "
                                 f"for {chunks} chunks, {len(got)} results")
        taat_total += launches
        for (gs, gi), (ws, wi) in zip(got, want):
            if gs != ws or not all(
                    same_up_to_ties(list(zip(a, x)), list(zip(b, x)))
                    for x, a, b in zip(gs, gi, wi)):
                raise AssertionError(f"stream {wire}: a batch differs from "
                                     f"search_encoded")
    progress("tiers", f"streams: {TIER_STREAMS} batches of {TIER_STREAM_B} "
             f"queries on each wire equal search_encoded batch by batch, "
             f"{chunks} TAAT launches each ({chunks} chunks); stream host "
             f"clock " + ", ".join(f"{w} {v:.2f} ms"
                                   for w, v in stream_ms.items())
             + f"; explain of {TIER_EXPLAIN} served tops equals the served "
             f"score")

    # ---- dense tiers --------------------------------------------------------
    flat = DenseFlatIndex(dim=dim, device=DEVICE)
    flat.add(rows, lookup)
    dense8 = DenseFlatIndex(dim=dim, dtype=torch.int8, device=DEVICE)
    dense8.add(rows, lookup)
    t0 = time.monotonic()
    proj = ip_projection(rows, TIER_ANN_RANK)
    proj_s = time.monotonic() - t0
    ann = DenseANNIndex.from_flat(flat, rank=TIER_ANN_RANK,
                                  candidates=TIER_ANN_CAND)
    ann_all = DenseANNIndex.from_flat(flat, rank=TIER_ANN_RANK,
                                      candidates=n)
    ann._proj = ann_all._proj = proj
    for d in (flat, dense8, ann, ann_all):
        d._materialize()
    torch.cuda.synchronize()
    q_text = np.stack(text_vecs)

    # SQ8: int32 accumulators exact, scores = the dequantized formula
    c8 = dense8._corpus_dev[:n, :dim].cpu().numpy()
    row_scale = dense8._row_scale_dev[:n].cpu().numpy().astype(np.float64)
    q8_all, qs_all = dense8._quantize_rows(q_text)
    sample = q8_all[:MAX_BATCH // 2]
    q8p = np.zeros((sample.shape[0], dense8._corpus_dev.shape[1]), np.int8)
    q8p[:, :dim] = sample
    acc = mips._int8_matmul(torch.from_numpy(q8p).to(DEVICE),
                            dense8._corpus_dev)[:, :n].cpu().numpy()
    if not np.array_equal(acc, sample.astype(np.int64)
                          @ c8.astype(np.int64).T):
        raise AssertionError("SQ8: int32 accumulators differ from an int64 "
                             "numpy product")
    s8, i8 = dense8.search_ids(q_text, DEPTH, batch_size=MAX_BATCH)
    dense_scores_ok(
        q_text, rows, [([pos[d] for d in r], s) for r, s in zip(i8, s8)],
        lambda r, p: (c8[p].astype(np.int64) @ q8_all[r].astype(np.int64))
        * (float(qs_all[r]) * row_scale[p]),
        "SQ8 scores against the float64 dequantized formula")
    sf, i_f = flat.search_ids(q_text, DEPTH, batch_size=MAX_BATCH)
    overlap8 = np.mean([len(set(a) & set(b)) / DEPTH
                        for a, b in zip(i8, i_f)])

    # ANN: exact scores, complete candidates = exact results, recall
    sa, ia = ann.search_ids(q_text, DEPTH, batch_size=MAX_BATCH)
    dense_scores_ok(
        q_text, rows, [([pos[d] for d in r], s) for r, s in zip(ia, sa)],
        lambda r, p: rows[p].astype(np.float64) @ q_text[r].astype(
            np.float64), "ANN scores against float64")
    sx, ix = ann_all.search_ids(q_text, DEPTH, batch_size=MAX_BATCH)
    for r in range(len(q_text)):
        if not close_up_to_ties(list(zip(ix[r], sx[r])),
                                list(zip(i_f[r], sf[r])), HYB_TOL):
            raise AssertionError(f"ANN with candidates >= N: query {r} "
                                 f"differs from the exact index")
    overlap_ann = np.mean([len(set(a) & set(b)) / DEPTH
                           for a, b in zip(ia, i_f)])
    del ann_all
    torch.cuda.empty_cache()
    low = low_rank_rows(np.random.default_rng(SEED + 6), n + 32, dim)
    low_q, low = low[:32], low[32:]
    low_exact = DenseFlatIndex(dim=dim, device=DEVICE)
    low_exact.add(low, lookup)
    low_ann = DenseANNIndex(dim=dim, device=DEVICE, rank=TIER_ANN_RANK,
                            candidates=TIER_ANN_CAND)
    low_ann.add(low, lookup)
    _, le = low_exact.search_ids(low_q, DEPTH, batch_size=MAX_BATCH)
    _, la = low_ann.search_ids(low_q, DEPTH, batch_size=MAX_BATCH)
    recall = np.mean([len(set(a) & set(b)) / DEPTH for a, b in zip(la, le)])
    if recall < TIER_RECALL_FLOOR:
        raise AssertionError(f"ANN candidate recall@{DEPTH} {recall:.4f} on "
                             f"low-rank rows < {TIER_RECALL_FLOOR}")
    del low_exact, low_ann, low
    torch.cuda.empty_cache()
    progress("tiers", f"SQ8 [{n} x {dim}] int8 (padded to "
             f"{tuple(dense8._corpus_dev.shape)}): int32 accumulators of "
             f"{sample.shape[0]} queries equal an int64 numpy product; "
             f"{len(q_text)} queries' scores within {TIER_REL} relative of "
             f"the float64 dequantized formula; top-{DEPTH} overlap with "
             f"the f32 index {overlap8:.4f}. ANN rank {TIER_ANN_RANK}, "
             f"{TIER_ANN_CAND} candidates: ip_projection {proj_s:.2f} s at "
             f"{n} x {dim}; every score within {TIER_REL} relative of "
             f"float64; with {n} candidates equal to the exact index; "
             f"top-{DEPTH} overlap with the f32 index {overlap_ann:.4f}; "
             f"candidate recall@{DEPTH} on rank-{TIER_LOW_RANK} rows "
             f"{recall:.4f} (floor {TIER_RECALL_FLOOR})")

    # ---- dense tiers served: dense mode, then device-fused hybrid ---------
    def dense_service(d):
        return lambda: RetrievalService(
            dense_index=d, max_batch=MAX_BATCH, device_batch=MAX_BATCH,
            depth_levels=(DEPTH,), max_wait_ms=10.0)

    def hybrid_service(d):
        return lambda: RetrievalService(
            d, index, query_encoder=txt_enc, backend="taat",
            alpha=HYB_ALPHA, candidate_depth=HYB_CAND, max_batch=MAX_BATCH,
            device_batch=MAX_BATCH, depth_levels=(DEPTH,), max_wait_ms=10.0)

    n_b = {}
    for name, d in (("f32", flat), ("int8", dense8), ("ann", ann)):
        res = served(f"dense {name}", dense_service(d), "dense", text_vecs, 0)
        ref_s, ref_i = d.search_ids(q_text, DEPTH, batch_size=MAX_BATCH)
        for r, got in enumerate(res):
            if not close_up_to_ties(got, list(zip(ref_i[r], ref_s[r])),
                                    HYB_TOL):
                raise AssertionError(f"dense {name}: query {r} differs "
                                     f"from search_ids")
        if name == "f32":
            continue
        res = served(f"hybrid {name}", hybrid_service(d), "text", texts, 1)
        n_b[name] = check_hybrid(f"hybrid text, {name} dense index", txt_enc,
                                 texts, res, d, index, cmap)
    progress("tiers", f"dense mode (f32, int8, ANN) equals search_ids; "
             f"device-fused hybrid with the int8 and the ANN index equals "
             f"the host fuse of the two engines' runs within {HYB_TOL} "
             f"({n_b['int8']} and {n_b['ann']} batches, each with a doc "
             f"found by both runs), one TAAT launch per micro-batch; "
             + "; ".join(f"{k} {v}" for k, v in lines.items()
                         if k.startswith(("dense", "hybrid"))))

    # ---- one dense search in each tier: device and host time ---------------
    bf16 = DenseFlatIndex(dim=dim, dtype=torch.bfloat16, device=DEVICE)
    bf16.add(rows, lookup)
    bf16._materialize()
    chunk = np.ascontiguousarray(q_text[:MAX_BATCH])
    tier_ms = {}
    for name, d in (("f32", flat), ("bf16", bf16), ("int8", dense8),
                    ("ann", ann)):
        def one(d=d):
            d._dispatch_chunk(chunk, DEPTH).cpu()
        busy, kernels, _, _ = profiled_again(one, stages=())
        if busy <= 0.0:
            raise AssertionError(f"the profiler saw no device time in the "
                                 f"{name} dense search")
        tier_ms[name] = (busy, kernels, host_ms(one, TIER_PROFILE_ITERS))
    # the same programs on device tensors, replayed in a CUDA graph, beside
    # the bytes each must read once (the corpus, or ANN's projected rows
    # and its gathered candidate rows) at the card's memory rate
    q_dev = torch.from_numpy(chunk).to(DEVICE)
    q8c, qsc = dense8._quantize_rows(chunk)
    q8_dev = torch.zeros((MAX_BATCH, dense8._corpus_dev.shape[1]),
                         dtype=torch.int8, device=DEVICE)
    q8_dev[:, :dim] = torch.from_numpy(q8c).to(DEVICE)
    qs_dev = torch.from_numpy(qsc).to(DEVICE)
    ann_k = min(TIER_ANN_CAND, n)

    def bf16_whole_copy():
        """The bf16 search before the fix: an f32 copy of the corpus."""
        with full_f32_matmul():
            scores = q_dev.bfloat16().float() @ bf16._corpus_dev.float().T
        return pack_topk(*torch.topk(scores, DEPTH, dim=1))

    programs = {
        "f32": (lambda: mips.mips_topk_packed(q_dev, flat._corpus_dev,
                                              DEPTH), n * dim * 4),
        "bf16": (lambda: mips.mips_topk_packed(q_dev, bf16._corpus_dev,
                                               DEPTH), n * dim * 2),
        "bf16 with an f32 copy (PR 10)": (bf16_whole_copy, n * dim * 2),
        "int8": (lambda: mips.mips_topk_packed_q8(
            q8_dev, qs_dev, dense8._corpus_dev, dense8._row_scale_dev,
            DEPTH, n), n * (dim + 4)),
        "ann": (lambda: ann_topk_packed(
            q_dev, ann._corpus_dev, ann._corpus_r_dev, ann._proj_dev, DEPTH,
            ann_k), n * TIER_ANN_RANK * 4 + MAX_BATCH * ann_k * dim * 4),
    }
    graph_ms = {k: (device_ms(fn, TIER_PROFILE_ITERS),
                    nbytes / HBM_BYTES_PER_S * 1e3)
                for k, (fn, nbytes) in programs.items()}
    # the bf16 search's peak: its allocation + scores + slack, no f32 copy
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    bf16.search(chunk, DEPTH)
    torch.cuda.synchronize()
    over = torch.cuda.max_memory_allocated() - before
    slack = 2 * mips._WIDEN_BYTES + 8 * 2 ** 20
    if over > MAX_BATCH * n * 4 + slack:
        raise AssertionError(f"bf16 search peaked {over / 2 ** 20:.1f} MiB "
                             f"over its allocation")
    progress("tiers", f"one {MAX_BATCH}-query dense search at depth "
             f"{DEPTH} (device ms in kernels and copies, host clock): "
             + "; ".join(f"{k} {b:.4f} ms in {c}, {h:.3f} ms"
                         for k, (b, c, h) in tier_ms.items())
             + "; its program replayed in a CUDA graph (bytes bound): "
             + "; ".join(f"{k} {g:.4f} ms ({b:.4f} ms)"
                         for k, (g, b) in graph_ms.items())
             + f"; bf16 search {over / 2 ** 20:.2f} MiB over its "
             f"allocation (bound {(MAX_BATCH * n * 4 + slack) / 2 ** 20:.2f}"
             f" MiB); peak {peak_gb:.2f} GB; phase "
             f"{time.monotonic() - t_phase:.2f} s; card {card}")
    del flat, dense8, ann, bf16
    torch.cuda.empty_cache()
    return taat_total

class LiveCorpus:
    """The live document set as the phase's own host model, apart from the
    indexes under test: per doc its term keys and integer weights (the
    arena's ``int`` truncation, non-positive weights dropped) and its dense
    row. ``reference()`` rebuilds a static ``ImpactIndex`` and
    ``DenseFlatIndex`` of it, cached until the next change."""

    def __init__(self, index, rows, lookup):
        import numpy as np

        self.keys = list(index.term_to_idx)             # term id order
        self.col = {k: i for i, k in enumerate(self.keys)}
        self.sparse, self.dense = {}, {}
        for i, d in enumerate(index.doc_ids):
            w = index.doc_weights[i]
            live = w > 0
            self.sparse[d] = (index.doc_terms[i][live].astype(np.int32),
                              w[live].astype(np.float32))
        for i, d in enumerate(lookup):
            self.dense[d] = rows[i]
        self._ref = None

    def copy(self):
        out = LiveCorpus.__new__(LiveCorpus)
        out.keys, out.col = list(self.keys), dict(self.col)
        out.sparse, out.dense = dict(self.sparse), dict(self.dense)
        out._ref = None
        return out

    def add(self, docs):
        """``docs``: ``/documents`` entries with ``terms`` keyed by the
        index's keys and a ``dense`` row; the latest copy of an id wins."""
        import numpy as np

        for doc in docs:
            cols, ws = [], []
            for k, w in doc["terms"].items():
                k = int(k)
                if int(w) <= 0:
                    continue
                if k not in self.col:
                    self.col[k] = len(self.keys)
                    self.keys.append(k)
                cols.append(self.col[k])
                ws.append(int(w))
            self.sparse[doc["id"]] = (np.asarray(cols, np.int32),
                                      np.asarray(ws, np.float32))
            self.dense[doc["id"]] = np.asarray(doc["dense"], np.float32)
        self._ref = None

    def delete(self, ids):
        for d in ids:
            self.sparse.pop(d, None)
            self.dense.pop(d, None)
        self._ref = None

    def reference(self):
        """(static impact index, static dense index) of the live docs on
        the card, searched with the matmul backend and full f32."""
        import numpy as np

        from mllm_sparse_retrieval_tpu_torch.index import (
            DenseFlatIndex, ImpactIndex)

        if self._ref is None:
            ids = list(self.sparse)
            k = max(len(c) for c, _ in self.sparse.values())
            terms = np.zeros((len(ids), k), np.int32)
            weights = np.zeros((len(ids), k), np.float32)
            for r, (c, w) in enumerate(self.sparse.values()):
                terms[r, :c.size] = c
                weights[r, :c.size] = w
            imp = ImpactIndex.from_packed_arrays(
                terms, weights, doc_ids=ids, term_keys=self.keys,
                device=DEVICE)
            dense = DenseFlatIndex(device=DEVICE)
            dense.add(np.stack([self.dense[d] for d in ids]), ids)
            self._ref = (imp, dense)
        return self._ref


def live_check(label, corpus, terms_list, dense_q, served, deleted=()):
    """Each served row against the host fuse (``search.fusion.fuse``,
    weight HYB_ALPHA on the dense run) of the two engines' top-DEPTH runs
    on a static rebuild of the live documents (``LiveCorpus.reference``,
    matmul backend, f32), within LIVE_TOL, up to ties at a cut: where a
    doc below an engine's cut scores what its DEPTH-th doc scores (within
    LIVE_TOL), the docs at that score may enter that run either way, so
    they are left out of the comparison. No id of ``deleted`` may be
    served. Returns the number of queries with such a tie."""
    import numpy as np

    from mllm_sparse_retrieval_tpu_torch.search.fusion import fuse

    imp, dense = corpus.reference()
    s_s, s_i = imp.search(terms_list, LIVE_FETCH, backend="matmul")
    d_s, d_i = dense.search_ids(np.stack(dense_q), LIVE_FETCH)
    runs, tied = [{}, {}], [set() for _ in served]
    for e, (rows_s, rows_i, tol) in enumerate(((d_s, d_i, LIVE_TOL),
                                               (s_s, s_i, 0.0))):
        for j in range(len(served)):
            srow = [float(x) for x in rows_s[j]]
            irow = list(rows_i[j])
            if len(srow) > DEPTH and \
                    abs(srow[DEPTH] - srow[DEPTH - 1]) <= tol:
                tied[j] |= {d for d, x in zip(irow, srow)
                            if abs(x - srow[DEPTH - 1]) <= tol}
            srow, irow = srow[:DEPTH], irow[:DEPTH]
            if srow:
                runs[e][str(j)] = {"docs": dict(zip(irow, srow)),
                                   "max_score": srow[0],
                                   "min_score": srow[-1]}
    fused = fuse(runs, [HYB_ALPHA, 1.0 - HYB_ALPHA])
    gone = set(deleted)
    for j, got in enumerate(served):
        want = fused.get(str(j), {})
        got_ids = {d for d, _ in got}
        if not got or got_ids & gone:
            raise AssertionError(f"{label}: query {j} served {got} (deleted "
                                 f"ids: {sorted(got_ids & gone)[:5]})")
        for d, s in got:
            if d not in tied[j] and (d not in want
                                     or abs(want[d] - s) > LIVE_TOL):
                raise AssertionError(
                    f"{label}: query {j}: served {d} {s} != host fuse "
                    f"{want.get(d)}; served {got}")
        cut = float(got[-1][1]) if len(got) >= DEPTH else float("-inf")
        missed = [d for d, s in want.items() if d not in tied[j]
                  and s > cut + 2 * LIVE_TOL and d not in got_ids]
        if missed or (not tied[j] and len(got) != min(DEPTH, len(want))):
            raise AssertionError(f"{label}: query {j}: served {got}, host "
                                 f"fuse also ranks {missed}")
    return sum(bool(t) for t in tied)


def http_round(base, queries, n_threads, deadline_s):
    """One ``/search`` request per query from ``n_threads`` client threads:
    (result rows of (doc, score), latency seconds, wall seconds)."""
    from mllm_sparse_retrieval_tpu_torch.cli.ingest import _post

    results, latency = [None] * len(queries), [None] * len(queries)
    errors = []

    def client(rows):
        try:
            for i in rows:
                t_req = time.monotonic()
                out = _post(base, "/search", {"queries": [queries[i]]},
                            timeout=REQUEST_TIMEOUT_S)
                latency[i] = time.monotonic() - t_req
                results[i] = [(d, float(s)) for d, s in out["results"][0]]
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, daemon=True,
                                args=(range(k, len(queries), n_threads),))
               for k in range(n_threads)]
    t_run = time.monotonic()
    for th in threads:
        th.start()
    for th in threads:
        th.join(max(0.0, t_run + deadline_s - time.monotonic()))
    wall = time.monotonic() - t_run
    if any(th.is_alive() for th in threads):
        raise TimeoutError("the HTTP search path did not answer in time")
    if errors:
        raise errors[0]
    return results, latency, wall


def live_docs(rng, word_ids, p, cmap, ids, dim):
    """``/documents`` entries for ``ids``: DOC_K terms drawn like the
    corpus (Zipf word pieces folded through the canonical map, weights
    1..349) and a unit dense row."""
    import numpy as np

    toks = rng.choice(word_ids, size=(len(ids), DOC_K), p=p)
    ws = rng.integers(1, 350, size=(len(ids), DOC_K))
    vecs = rng.standard_normal((len(ids), dim), dtype=np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    docs = []
    for d, t, w, v in zip(ids, cmap[toks], ws, vecs):
        terms = {}
        for k, x in zip(t.tolist(), w.tolist()):
            if k >= 0:
                terms[k] = x                 # last write wins, as built
        docs.append({"id": d, "terms": terms, "dense": v})
    return docs


def as_json(docs):
    return [{"id": d["id"], "terms": {str(k): v for k, v in
                                      d["terms"].items()},
             "dense": [float(x) for x in d["dense"]]} for d in docs]


class ServeProcess:
    """``python -m mllm_sparse_retrieval_tpu_torch.cli.serve`` as a child
    process; its port comes from its ``serving mode=`` log line."""

    def __init__(self, args, boot_timeout_s):
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "mllm_sparse_retrieval_tpu_torch.cli.serve",
             *args], cwd=root, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        self.log, self.base, self.up_s = [], None, None
        self._t0 = time.monotonic()
        self._up = threading.Event()
        self._boot_timeout_s = boot_timeout_s
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        import re

        for line in self.proc.stderr:
            self.log.append(line)
            m = re.search(r"serving mode=\S+ on (http://[\d.]+:\d+)", line)
            if m:
                self.base = m.group(1)
                self.up_s = time.monotonic() - self._t0
                self._up.set()
        self._up.set()

    def wait_up(self) -> str:
        if not self._up.wait(self._boot_timeout_s) or self.base is None:
            self.stop()
            raise AssertionError("cli.serve did not come up:\n"
                                 + "".join(self.log[-30:]))
        return self.base

    def stop(self) -> int:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)
        return self.proc.returncode


def live_scratch_dir():
    """A scratch directory in RAM (``/dev/shm``) where it has room for the
    phase's artifacts and saves, else in the temp directory."""
    import shutil
    import tempfile

    shm = "/dev/shm"
    if os.path.isdir(shm) and shutil.disk_usage(shm).free > LIVE_SCRATCH_BYTES:
        return tempfile.mkdtemp(prefix="chip_smoke_live_", dir=shm)
    return tempfile.mkdtemp(prefix="chip_smoke_live_")


def phase_live(params, arch, arch_img, tok, tmpl, index, cmap, texts, host,
               word_ids, card):
    """Live indexes and the HTTP front end on the full-width model, beside
    the hybrid phase's dense rows and the impact index: copies wrapped in
    ``ArenaImpactIndex`` / ``ArenaDenseIndex`` serve a hybrid live service
    (TAAT, micro-batches of MAX_BATCH, depth DEPTH) built by ``cli.serve``'s
    boot function behind the aio server. Text queries over HTTP before and
    after adds, replaces and deletes over HTTP; the cached int16 matrix
    keeps its storage and the TAAT kernel on it equals its plain version;
    an add past the headroom (``_grow``), the int16 drop, ``/compact``,
    ``/save`` and ``load_live_state``; the same mutations through the
    segment classes; image documents encoded by ``encode_examples`` and
    posted by ``cli.ingest``'s helpers, each finding itself; and
    ``cli.serve --live`` as a child process against an in-process arena.
    Every served result is held to the host fuse of a static rebuild of
    the live documents (``live_check``). Returns the TAAT and flash
    launches of the served and encoded runs."""
    import shutil

    import numpy as np
    import torch

    from mllm_sparse_retrieval_tpu_torch.cli import ingest, serve as serve_cli
    from mllm_sparse_retrieval_tpu_torch.configs import SparseConfig
    from mllm_sparse_retrieval_tpu_torch.data.karpathy import Example
    from mllm_sparse_retrieval_tpu_torch.index import (
        ArenaDenseIndex, ArenaImpactIndex, DenseFlatIndex, ImpactIndex,
        LiveDenseIndex, LiveImpactIndex)
    from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA
    from mllm_sparse_retrieval_tpu_torch.ops import impact_kernel as K
    from mllm_sparse_retrieval_tpu_torch.ops.impact_kernel import (
        prepare_query_arrays)
    from mllm_sparse_retrieval_tpu_torch.pipelines.encode import (
        encode_examples)
    from mllm_sparse_retrieval_tpu_torch.serving import (
        OnlineQueryEncoder, RetrievalService, load_live_state)

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    rows, lookup, _ = host
    dim = rows.shape[1]
    rng = np.random.default_rng(SEED + 6)
    p = zipf_p(word_ids.size)
    corpus = LiveCorpus(index, rows, lookup)
    corpus0 = corpus.copy()
    taat_total = flash_total = 0
    scratch = live_scratch_dir()
    child = svc = server = None
    restore = []
    try:
        # ---- artifacts for the child cli.serve, started now ---------------
        t0 = time.monotonic()
        index.save(os.path.join(scratch, "sparse"))
        os.makedirs(os.path.join(scratch, "dense"))
        static_dense = DenseFlatIndex(dim=dim, device=DEVICE)
        static_dense.add(rows, lookup)
        static_dense.save_shard(os.path.join(scratch, "dense",
                                             "corpus_0.pkl"))
        del static_dense
        child = ServeProcess(
            ["--sparse-index", os.path.join(scratch, "sparse"),
             "--passage-reps", os.path.join(scratch, "dense"), "--live",
             "--live-state", os.path.join(scratch, "child_state"),
             "--port", "0", "--impact-backend", "taat", "--max-batch",
             str(MAX_BATCH), "--depths", str(DEPTH), "--max-wait-ms", "10",
             "--alpha", str(HYB_ALPHA), "--device", DEVICE],
            LIVE_BOOT_TIMEOUT_S)
        progress("live", f"artifacts written to {scratch} in "
                 f"{time.monotonic() - t0:.2f} s; cli.serve --live started "
                 f"as a child process")

        # ---- the live service: cli.serve's boot, aio, in a thread ---------
        dense_copy = DenseFlatIndex(dim=dim, device=DEVICE)
        dense_copy.add(rows, lookup)
        impact_copy = ImpactIndex.from_packed_arrays(
            index.doc_terms, index.doc_weights, doc_ids=index.doc_ids,
            term_keys=list(index.term_to_idx), device=DEVICE)
        impact_copy.query_canonical = index.query_canonical
        enc = RecordingEncoder(OnlineQueryEncoder(
            params, arch, tok, tmpl, SparseConfig(), max_text_len=64,
            device=DEVICE))
        args = serve_cli.build_parser().parse_args(
            ["--live", "--live-impl", "arena", "--impact-backend", "taat",
             "--max-batch", str(MAX_BATCH), "--depths", str(DEPTH),
             "--max-wait-ms", "10", "--alpha", str(HYB_ALPHA), "--port", "0",
             "--http-impl", "aio", "--device", DEVICE])
        t0 = time.monotonic()
        svc, server = serve_cli.boot(args, enc,
                                     indexes=(dense_copy, impact_copy))
        server_thread = threading.Thread(target=server.serve_forever,
                                         daemon=True)
        server_thread.start()
        base = "http://%s:%d" % server.server_address[:2]
        arena_s, arena_d = svc.impact_index, svc.dense_index
        inner = arena_s._inner
        if (not isinstance(arena_s, ArenaImpactIndex)
                or not isinstance(arena_d, ArenaDenseIndex)
                or arena_s.doc_headroom != LIVE_HEADROOM):
            raise AssertionError("cli.serve --live did not wrap the indexes "
                                 "in the default arenas")
        i16 = inner._dev["i16"]
        ptr, cap = i16.data_ptr(), tuple(i16.shape)
        progress("live", f"boot (live wrap, warm-up, aio bind) "
                 f"{time.monotonic() - t0:.2f} s; i16 matrix {cap} "
                 f"({i16.numel() * 2 / 1e9:.2f} GB, {index.num_docs} docs + "
                 f"{LIVE_HEADROOM} reserved columns), dense corpus "
                 f"{tuple(arena_d._inner._corpus_dev.shape)}; serving on "
                 f"{base}")
        builds = []
        real_materialize = ImpactIndex._materialize

        def counting_materialize(self, dtype="f32"):
            if self is arena_s._inner and dtype not in (self._dev or {}):
                builds.append(dtype)
            return real_materialize(self, dtype)

        ImpactIndex._materialize = counting_materialize
        restore.append((ImpactIndex, "_materialize", real_materialize))
        grows = []
        real_grow = {cls: cls._grow for cls in (ArenaImpactIndex,
                                                ArenaDenseIndex)}

        def timed_grow(cls):
            def grow(self, *a, **kw):
                t = time.monotonic()
                real_grow[cls](self, *a, **kw)
                torch.cuda.synchronize()
                grows.append((cls.__name__, time.monotonic() - t))
            return grow

        for cls, fn in real_grow.items():
            cls._grow = timed_grow(cls)
            restore.append((cls, "_grow", fn))

        def text_round(label, state, deleted=()):
            """The text queries over HTTP (N_THREADS clients), then in
            process: both held to ``live_check``; one TAAT launch per
            sparse micro-batch."""
            nonlocal taat_total
            out = {}
            for how in ("http", "in-process"):
                enc.calls.clear()
                K.reset_launch_count()
                b0 = svc.stats()["batches"]
                if how == "http":
                    res, lat, wall = http_round(
                        base, [{"text": t, "depth": DEPTH} for t in texts],
                        N_THREADS, SERVE_DEADLINE_S)
                else:
                    res, lat, wall = serve(svc, "text", texts, N_THREADS,
                                           REQUEST_TIMEOUT_S,
                                           SERVE_DEADLINE_S)
                taat, batches = K.launch_count(), \
                    svc.stats()["batches"] - b0
                taat_total += taat
                if taat != batches or batches != len(enc.calls):
                    raise AssertionError(f"{label} {how}: {taat} TAAT "
                                         f"launches in {batches} batches")
                ties = live_check(
                    f"{label} {how}", state,
                    [terms_dict(enc.terms[t], cmap) for t in texts],
                    [enc.dense[t] for t in texts], res, deleted)
                out[how] = (res, latency_line(lat, len(texts), wall),
                            batches, ties)
            progress("live", f"{label}: HTTP {out['http'][1]}; in-process "
                     f"{out['in-process'][1]}; {out['http'][2]} + "
                     f"{out['in-process'][2]} micro-batches, one TAAT launch "
                     f"each; every result equals the host fuse of a static "
                     f"rebuild ({out['http'][3]} + {out['in-process'][3]} "
                     f"queries with a tie at an engine's cut); card {card}")
            return out

        # ---- 1. text queries before any mutation -------------------------
        http_round(base, [{"text": texts[0], "depth": DEPTH}], 1,
                   SERVE_DEADLINE_S)        # the first connection, untimed
        before = text_round("before mutations", corpus)
        q_terms = {t: terms_dict(enc.terms[t], cmap) for t in texts}
        q_dense = {t: enc.dense[t] for t in texts}

        # ---- mutations over HTTP: adds, replaces, deletes ---------------
        new_ids = [f"live{i}" for i in range(LIVE_POSTS * LIVE_POST_DOCS)]
        new_docs = live_docs(rng, word_ids, p, cmap, new_ids, dim)
        for i, t in enumerate(texts[:LIVE_PLANT]):
            # planted: the query's own terms at a weight above any corpus
            # weight (so above any corpus doc's score), and its vector
            new_docs[i]["terms"] = {k: LIVE_PLANT_WEIGHT for k in q_terms[t]}
            new_docs[i]["dense"] = q_dense[t]
        base_ids = list(index.doc_ids)
        pick = rng.permutation(len(base_ids))
        replaced = [base_ids[i] for i in pick[:LIVE_REPLACE]]
        deleted = [base_ids[i]
                   for i in pick[LIVE_REPLACE:LIVE_REPLACE + LIVE_DELETE]]
        replace_docs = live_docs(rng, word_ids, p, cmap, replaced, dim)
        add_ms, t_mut = [], time.monotonic()
        for r in range(LIVE_POSTS):
            part = new_docs[r * LIVE_POST_DOCS:(r + 1) * LIVE_POST_DOCS]
            payload = {"documents": as_json(part)}
            t0 = time.monotonic()
            out = ingest._post(base, "/documents", payload)
            add_ms.append((time.monotonic() - t0) * 1e3)
            if out != {"added": len(part)}:
                raise AssertionError(f"POST /documents: {out}")
        t0 = time.monotonic()
        out = ingest._post(base, "/documents",
                           {"documents": as_json(replace_docs)})
        replace_ms = (time.monotonic() - t0) * 1e3
        t0 = time.monotonic()
        gone = ingest._post(base, "/documents/delete", {"ids": deleted})
        delete_ms = (time.monotonic() - t0) * 1e3
        if out != {"added": LIVE_REPLACE} or \
                gone != {"deleted": LIVE_DELETE}:
            raise AssertionError(f"replace {out}, delete {gone}")
        corpus.add(new_docs + replace_docs)
        corpus.delete(deleted)
        progress("live", f"over HTTP: {LIVE_POSTS} adds of "
                 f"{LIVE_POST_DOCS} docs ({DOC_K} terms, {dim}-wide dense; "
                 f"{LIVE_PLANT} planted on the first queries) in "
                 + ", ".join(f"{x:.1f}" for x in add_ms)
                 + f" ms; {LIVE_REPLACE} replaces in {replace_ms:.1f} ms; "
                 f"{LIVE_DELETE} deletes in {delete_ms:.1f} ms; "
                 f"{time.monotonic() - t_mut:.2f} s in all")

        # ---- 2. text queries after; the arena's promise ------------------
        after = text_round("after mutations", corpus, deleted)
        for how in ("http", "in-process"):
            for i, t in enumerate(texts[:LIVE_PLANT]):
                row = after[how][0][texts.index(t)]
                if row[0][0] != new_ids[i]:
                    raise AssertionError(f"planted {new_ids[i]} not first "
                                         f"for its query: {row[:3]}")
        if builds or inner._dev["i16"].data_ptr() != ptr or \
                tuple(inner._dev["i16"].shape) != cap:
            raise AssertionError(f"the i16 matrix was rebuilt or moved "
                                 f"({builds})")
        q_idx, q_w = inner.encode_queries(
            [q_terms[t] for t in texts[:MAX_BATCH]])
        safe_idx, safe_w = (torch.from_numpy(a).to(DEVICE)
                            for a in prepare_query_arrays(q_idx, q_w))
        check_kernel(f"live: mutated capacity matrix {cap} int16, "
                     f"B={q_idx.shape[0]} Q={q_idx.shape[1]}",
                     inner._dev["i16"], safe_idx, safe_w, iters=50)
        # one 256-doc add's scatter, again (the same values: idempotent)
        last = new_docs[-LIVE_POST_DOCS:]
        t2i = inner.term_to_idx
        tr = [(t2i[k], arena_s._pos[d["id"]], float(w)) for d in last
              for k, w in d["terms"].items()]
        terms_a, cols_a, vals_a = (np.array(x) for x in zip(*tr))
        scatter_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            inner.scatter_append_triples(terms_a, cols_a, vals_a)
            e1.record()
            e1.synchronize()
            scatter_ms.append(e0.elapsed_time(e1))
        progress("live", f"the i16 matrix kept its storage and shape "
                 f"through the adds and deletes, no matrix built; one "
                 f"{LIVE_POST_DOCS}-doc add's scatter ({len(tr)} triples "
                 f"into every cached matrix, uploads included): "
                 + ", ".join(f"{x:.3f}" for x in scatter_ms)
                 + f" ms (CUDA events); card {card}")

        # ---- 4b. the same mutations through the segment classes ----------
        seg_s = LiveImpactIndex(ImpactIndex.from_packed_arrays(
            index.doc_terms, index.doc_weights, doc_ids=index.doc_ids,
            term_keys=list(index.term_to_idx), device=DEVICE))
        seg_s.query_canonical = index.query_canonical
        seg_dense = DenseFlatIndex(dim=dim, device=DEVICE)
        seg_dense.add(rows, lookup)
        seg_d = LiveDenseIndex(seg_dense)
        seg_svc = RetrievalService(
            seg_d, seg_s, backend="taat", alpha=HYB_ALPHA,
            max_batch=MAX_BATCH, depth_levels=(DEPTH,), max_wait_ms=10.0)
        try:
            for r in range(LIVE_POSTS):
                seg_svc.add_documents(
                    new_docs[r * LIVE_POST_DOCS:(r + 1) * LIVE_POST_DOCS])
            seg_svc.add_documents(replace_docs)
            seg_svc.delete_documents(deleted)
            K.reset_launch_count()
            b0 = seg_svc.stats()["batches"]
            futs = [seg_svc.search_async(terms=q_terms[t], dense=q_dense[t])
                    for t in texts]
            seg_res = [f.result(REQUEST_TIMEOUT_S) for f in futs]
            seg_taat, seg_b = K.launch_count(), \
                seg_svc.stats()["batches"] - b0
            taat_total += seg_taat
            ties = live_check("segments", corpus,
                              [q_terms[t] for t in texts],
                              [q_dense[t] for t in texts], seg_res, deleted)
            if seg_taat != seg_b:
                raise AssertionError(f"segments: {seg_taat} TAAT launches "
                                     f"in {seg_b} batches")
            progress("live", f"segments (--live-impl segments): "
                     f"{seg_s.num_segments} sparse and {seg_d.num_segments} "
                     f"dense segments; {len(texts)} queries in {seg_b} "
                     f"micro-batches, TAAT launched by the base segment "
                     f"only ({seg_taat}); results equal the same host fuse "
                     f"as the arena's ({ties} queries with a tie at a cut)")
        finally:
            seg_svc.close()
            del seg_svc, seg_s, seg_d, seg_dense
            torch.cuda.empty_cache()

        # ---- 3. capacity: _grow, then the int16 drop ---------------------
        grow_ids = [f"grow{i}" for i in range(LIVE_GROW_DOCS)]
        grow_docs = live_docs(rng, word_ids, p, cmap, grow_ids, dim)
        t0 = time.monotonic()
        svc.add_documents(grow_docs)
        torch.cuda.synchronize()
        grow_add_s = time.monotonic() - t0
        corpus.add(grow_docs)
        if sorted(g for g, _ in grows) != ["ArenaDenseIndex",
                                           "ArenaImpactIndex"]:
            raise AssertionError(f"{LIVE_GROW_DOCS} docs past the headroom "
                                 f"grew {grows}")
        progress("live", f"one in-process add of {LIVE_GROW_DOCS} docs past "
                 f"the headroom: {grow_add_s:.2f} s, of which _grow "
                 + ", ".join(f"{g} {s:.2f} s" for g, s in grows)
                 + f"; new capacity {arena_s._inner.doc_capacity} columns")
        text_round("after _grow", corpus, deleted)
        # on the last query with a term of integer weight >= 1: that term
        # at 40,000, the rest at LIVE_PLANT_WEIGHT, its vector; scores must
        # stay integers below 2^24 (exact in f32)
        big_q = next(i for i in reversed(range(len(texts)))
                     if max(map(int, q_terms[texts[i]].values())) >= 1)
        last_terms = q_terms[texts[big_q]]
        top_term = max(last_terms, key=last_terms.get)
        big = {"id": "big_weight", "dense": q_dense[texts[big_q]],
               "terms": {k: LIVE_BIG_WEIGHT if k == top_term
                         else LIVE_PLANT_WEIGHT for k in last_terms}}
        if sum(int(w) * big["terms"][k]
               for k, w in last_terms.items()) >= 2 ** 24:
            raise AssertionError("the 40,000-weight doc's score would pass "
                                 "2^24")
        ingest._post(base, "/documents", {"documents": as_json([big])})
        corpus.add([big])
        if arena_s._inner._i16_ok is not False or "i16" in (
                arena_s._inner._dev or {}):
            raise AssertionError("a weight of 40,000 kept the i16 matrix")
        drop = text_round("after the int16 drop", corpus, deleted)
        if drop["http"][0][big_q][0][0] != "big_weight":
            raise AssertionError("the 40,000-weight doc is not first")
        if "f32" not in arena_s._inner._dev:
            raise AssertionError("the TAAT search did not rebuild in f32")

        # ---- 4. /compact, /save, load_live_state -------------------------
        t0 = time.monotonic()
        out = ingest._post(base, "/compact", {})
        compact_s = time.monotonic() - t0
        saved = os.path.join(scratch, "saved")
        t0 = time.monotonic()
        out_save = ingest._post(base, "/save", {"directory": saved})
        save_s = time.monotonic() - t0
        if out != {"ok": True, "sparse_segments": 1, "dense_segments": 1} \
                or out_save != {"ok": True, "directory": saved}:
            raise AssertionError(f"/compact {out}, /save {out_save}")
        text_round("after /compact", corpus, deleted)
        t0 = time.monotonic()
        back = RetrievalService(*load_live_state(saved, device=DEVICE),
                                backend="taat", alpha=HYB_ALPHA,
                                max_batch=MAX_BATCH, depth_levels=(DEPTH,),
                                max_wait_ms=10.0)
        try:
            K.reset_launch_count()
            futs = [back.search_async(terms=q_terms[t], dense=q_dense[t])
                    for t in texts]
            back_res = [f.result(REQUEST_TIMEOUT_S) for f in futs]
            taat_total += K.launch_count()
            load_s = time.monotonic() - t0
            live_check("load_live_state", corpus,
                       [q_terms[t] for t in texts],
                       [q_dense[t] for t in texts], back_res, deleted)
            if not isinstance(back.impact_index, ArenaImpactIndex):
                raise AssertionError("the save did not load as an arena")
        finally:
            back.close()
            del back
            torch.cuda.empty_cache()
        save_gb = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(saved) for f in fs) / 1e9
        progress("live", f"/compact {compact_s:.2f} s, /save "
                 f"{save_s:.2f} s ({save_gb:.2f} GB), "
                 f"load_live_state + first {len(texts)} searches "
                 f"{load_s:.2f} s: results equal the host fuse before and "
                 f"after")

        # ---- 5. ingest: image documents posted by cli.ingest's helpers ---
        img_rng = np.random.default_rng(SEED + 7)
        images = {}
        examples = []
        for i in range(LIVE_INGEST):
            hw = IMAGE_SIZES[i % len(IMAGE_SIZES)]
            images[f"ing{i}"] = img_rng.integers(
                0, 256, size=hw + (3,), dtype=np.uint8).astype(
                    np.float32) / 255.0
            examples.append(Example(f"image {i}", f"/nonexistent/ing{i}.jpg",
                                    f"t_ing{i}", f"ing{i}"))
        encoded = {}
        for is_query in (False, True):
            FA.reset_launch_count()
            t0 = time.monotonic()
            encoded[is_query] = encode_examples(
                examples, params, arch_img, tok, tmpl, encode_type="image",
                sparse_cfg=SparseConfig(), batch_size=MAX_BATCH,
                is_query=is_query,
                pixel_loader=lambda ex: images[ex.img_id], device=DEVICE)
            torch.cuda.synchronize()
            flash = FA.launch_count()
            flash_total += flash
            want = arch_img.text.num_layers * -(-LIVE_INGEST // MAX_BATCH)
            if flash != want:
                raise AssertionError(f"ingest encode: {flash} flash "
                                     f"launches, expected {want}")
            progress("live", f"encode_examples of {LIVE_INGEST} images as "
                     f"{'queries' if is_query else 'documents'}: "
                     f"{time.monotonic() - t0:.2f} s, {flash} flash "
                     f"launches ({arch_img.text.num_layers} per batch of "
                     f"{MAX_BATCH})")
        docs, skipped = ingest._doc_payload(encoded[False], 0, LIVE_INGEST,
                                            True, True)
        if skipped or ingest._post(base, "/documents", {
                "documents": docs}) != {"added": LIVE_INGEST}:
            raise AssertionError(f"ingest: skipped {skipped}")
        qr = encoded[True]
        K.reset_launch_count()
        queries = []
        for j in range(LIVE_INGEST):
            st = qr.selected_terms[j]
            queries.append({"depth": DEPTH,
                            "dense": [float(x) for x in qr.dense[j]],
                            "terms": {str(int(t)): float(w) for t, w in
                                      zip(st.token_ids.tolist(),
                                          st.weights.tolist()) if w > 0}})
        res, lat, wall = http_round(base, queries, N_THREADS,
                                    SERVE_DEADLINE_S)
        taat_total += K.launch_count()
        tops = [row[0][0] if row else None for row in res]
        if tops != list(qr.ids):
            raise AssertionError(f"ingest query smoke: {tops} != "
                                 f"{list(qr.ids)}")
        progress("live", f"ingest: {LIVE_INGEST} image docs posted "
                 f"(cli.ingest._doc_payload / _post); each image, encoded "
                 f"again as a query, finds itself first; "
                 f"{latency_line(lat, LIVE_INGEST, wall)}")

        # ---- 6. cli.serve as a child process ------------------------------
        child_base = child.wait_up()
        local = RetrievalService(
            ArenaDenseIndex(DenseFlatIndex.load(
                os.path.join(scratch, "dense"), device=DEVICE)),
            ArenaImpactIndex(ImpactIndex.load(
                os.path.join(scratch, "sparse"), device=DEVICE)),
            backend="taat", alpha=HYB_ALPHA, max_batch=MAX_BATCH,
            depth_levels=(DEPTH,), max_wait_ms=10.0)
        try:
            one = as_json(live_docs(rng, word_ids, p, cmap, ["child0"],
                                    dim))[0]
            one["terms"] = {str(k): 250 for k in q_terms[texts[0]]}
            victim = before["http"][0][1][0][0]      # a corpus doc
            checks = []
            for step in ("before", "after"):
                qs = [{"terms": {str(k): v for k, v in q_terms[t].items()},
                       "dense": [float(x) for x in q_dense[t]],
                       "depth": DEPTH} for t in texts]
                got, lat, wall = http_round(child_base, qs, N_THREADS,
                                            SERVE_DEADLINE_S)
                mine = [local.search(terms=q_terms[t], dense=q_dense[t],
                                     timeout=REQUEST_TIMEOUT_S)
                        for t in texts]
                for label, rows_ in (("child", got), ("in-process", mine)):
                    live_check(f"cli.serve {label} {step}", corpus0,
                               [q_terms[t] for t in texts],
                               [q_dense[t] for t in texts], rows_,
                               [victim] if step == "after" else ())
                bad = [j for j, (a, b) in enumerate(zip(got, mine))
                       if not close_up_to_ties(a, b, LIVE_TOL)]
                if bad:
                    raise AssertionError(f"cli.serve child != in-process "
                                         f"arena at queries {bad}")
                checks.append(latency_line(lat, len(texts), wall))
                if step == "before":
                    one_doc = dict(one, terms={int(k): v for k, v in
                                               one["terms"].items()})
                    if ingest._post(child_base, "/documents", {
                            "documents": [one]}) != {"added": 1} or \
                            ingest._post(child_base, "/documents/delete",
                                         {"ids": [victim]}) != \
                            {"deleted": 1}:
                        raise AssertionError("child add/delete failed")
                    local.add_documents([one_doc])
                    local.delete_documents([victim])
                    corpus0.add([one_doc])
                    corpus0.delete([victim])
        finally:
            local.close()
            del local
        rc, up_s = child.stop(), child.up_s
        child_log = "".join(child.log)
        child = None
        state = os.path.join(scratch, "child_state")
        saved_ids = ImpactIndex.load(os.path.join(state, "sparse", "seg0"),
                                     device="cpu").doc_ids
        if rc != 0 or "child0" not in saved_ids or victim in saved_ids or \
                not os.path.exists(os.path.join(state, "dense", "live.json")):
            raise AssertionError(f"cli.serve exited {rc} without its live "
                                 f"state:\n{child_log[-3000:]}")
        progress("live", f"cli.serve --live child process (up "
                 f"{up_s:.2f} s after its start, beside the phase's work): "
                 f"HTTP "
                 f"{checks[0]} before and {checks[1]} after one add and one "
                 f"delete; results equal the in-process arena's and the "
                 f"host fuse; stopped (exit 0), live state saved with the "
                 f"add and without the delete")
    finally:
        for owner, name, fn in restore:
            setattr(owner, name, fn)
        if server is not None:
            server.shutdown()
            server.server_close()
        if svc is not None:
            svc.close()
        if child is not None:
            child.stop()
        shutil.rmtree(scratch, ignore_errors=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    progress("live", f"phase {time.monotonic() - t_phase:.2f} s; peak "
             f"{peak_gb:.2f} GB; TAAT launches {taat_total}, flash "
             f"{flash_total}; card {card}")
    gc.collect()
    torch.cuda.empty_cache()
    return taat_total, flash_total


def tree_leaves(tree, path=()):
    """``(path, tensor)`` of every leaf of a parameter tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (i,))
    else:
        yield path, tree


def checksums(params):
    """``{path: (shape, s1, s2)}``: per bf16 tensor, the int64 sums of its
    16-bit patterns and of those weighted by position mod CHECKSUM_MOD."""
    import torch

    sums, shapes = [], {}
    for path, t in tree_leaves(params):
        bits = t.detach().contiguous().view(-1).view(torch.int16)
        s1 = torch.zeros((), dtype=torch.int64, device=t.device)
        s2 = torch.zeros_like(s1)
        for lo in range(0, bits.numel(), CHECKSUM_CHUNK):
            x = bits[lo:lo + CHECKSUM_CHUNK].to(torch.int64)
            w = torch.arange(lo, lo + x.numel(), device=t.device) \
                % CHECKSUM_MOD + 1
            s1 += x.sum()
            s2 += (x * w).sum()
        sums.append(torch.stack([s1, s2]))
        shapes[path] = tuple(t.shape)
    host = torch.stack(sums).cpu().tolist()
    return {p: (shapes[p],) + tuple(h) for p, h in zip(shapes, host)}


def hf_checkpoint_tensors(params, arch):
    """``(HF name, tensor view on the card)`` of every weight of the port's
    tree in the hub's legacy llava / llava_next key layout: ``[out, in]``
    linear weights, CLIP q/k/v split, the conv patch embedding
    ``[H, 3, P, P]`` (the inverse of ``convert_llava_state_dict``)."""
    vt, lm = "vision_tower.vision_model", "language_model.model"
    vis, text = params["vision"], params["text"]
    p, h = arch.vision.patch_size, arch.vision.hidden_size

    def linear(name, d):
        out = [(f"{name}.weight", d["w"].T)]
        if "b" in d:
            out.append((f"{name}.bias", d["b"]))
        return out

    def norm(name, d):
        out = [(f"{name}.weight", d["scale"])]
        if "bias" in d:
            out.append((f"{name}.bias", d["bias"]))
        return out

    out = [(f"{vt}.embeddings.patch_embedding.weight",
            vis["patch_embed"]["w"].reshape(p, p, 3, h).permute(3, 2, 0, 1)),
           (f"{vt}.embeddings.class_embedding", vis["cls_token"]),
           (f"{vt}.embeddings.position_embedding.weight", vis["pos_embed"])]
    out += norm(f"{vt}.pre_layrnorm", vis["pre_ln"])
    for i, blk in enumerate(vis["blocks"]):
        pre = f"{vt}.encoder.layers.{i}"
        for j, part in enumerate("qkv"):
            one = {"w": blk["qkv"]["w"][:, j * h:(j + 1) * h]}
            if "b" in blk["qkv"]:
                one["b"] = blk["qkv"]["b"][j * h:(j + 1) * h]
            out += linear(f"{pre}.self_attn.{part}_proj", one)
        out += linear(f"{pre}.self_attn.out_proj", blk["out"])
        out += norm(f"{pre}.layer_norm1", blk["ln1"])
        out += norm(f"{pre}.layer_norm2", blk["ln2"])
        out += linear(f"{pre}.mlp.fc1", blk["fc1"])
        out += linear(f"{pre}.mlp.fc2", blk["fc2"])
    for j in (1, 2):
        out += linear(f"multi_modal_projector.linear_{j}",
                      params["projector"][f"fc{j}"])
    out.append((f"{lm}.embed_tokens.weight", text["embed"]))
    for i, blk in enumerate(text["blocks"]):
        pre = f"{lm}.layers.{i}"
        out += norm(f"{pre}.input_layernorm", blk["attn_norm"])
        for part in "qkvo":
            out += linear(f"{pre}.self_attn.{part}_proj", blk[part])
        out += norm(f"{pre}.post_attention_layernorm", blk["mlp_norm"])
        for part in ("gate", "up", "down"):
            out += linear(f"{pre}.mlp.{part}_proj", blk[part])
    out += norm(f"{lm}.norm", text["final_norm"])
    if "lm_head" in text:
        out += linear("language_model.lm_head", text["lm_head"])
    if "image_newline" in params:
        out.append(("image_newline", params["image_newline"]))
    return out


def hf_config(arch):
    """The ``config.json`` of an HF llava_next checkpoint of ``arch``."""
    t, v = arch.text, arch.vision
    return {
        "architectures": ["LlavaNextForConditionalGeneration"],
        "model_type": "llava_next", "torch_dtype": "bfloat16",
        "image_token_index": arch.image_token_id,
        "image_grid_pinpoints": [list(x) for x in arch.grid_pinpoints],
        "vision_feature_layer": v.feature_layer,
        "vision_feature_select_strategy": "default",
        "projector_hidden_act": "gelu", "tie_word_embeddings": False,
        "text_config": {
            "model_type": "llama", "vocab_size": t.vocab_size,
            "hidden_size": t.hidden_size, "num_hidden_layers": t.num_layers,
            "num_attention_heads": t.num_heads,
            "num_key_value_heads": t.num_kv_heads,
            "intermediate_size": t.intermediate_size,
            "max_position_embeddings": t.max_seq_len,
            "rope_theta": t.rope_theta, "rms_norm_eps": t.rms_eps,
            "attention_bias": t.qkv_bias,
            "tie_word_embeddings": t.tie_lm_head},
        "vision_config": {
            "model_type": "clip_vision_model", "image_size": v.image_size,
            "patch_size": v.patch_size, "hidden_size": v.hidden_size,
            "num_hidden_layers": v.num_layers,
            "num_attention_heads": v.num_heads,
            "intermediate_size": v.hidden_size * v.mlp_ratio,
            "hidden_act": v.act},
    }


def ram_file(directory, name):
    """An open file ``directory/name`` whose bytes live in RAM: a memfd,
    linked into the directory by name through ``/proc``. Closing it frees
    them. The converter's f32 ``params.pkl`` alone is 33.4 GB; keeping the
    16.7 GB of bf16 shards it reads in RAM holds the script's disk writes
    under 45 GiB, a per-run cap some card hosts set."""
    fd = os.memfd_create(name)
    os.symlink(f"/proc/{os.getpid()}/fd/{fd}", os.path.join(directory, name))
    return os.fdopen(fd, "w+b")


def write_hf_checkpoint(tensors, config, out_dir, shard_file):
    """bf16 safetensors shards of at most ``CKPT_SHARD_BYTES`` (each an
    8-byte little-endian header length, the JSON header, the raw tensors),
    each written into ``shard_file(out_dir, name)``, which stays open;
    ``model.safetensors.index.json`` and ``config.json``. Each tensor goes
    from the card into its shard at its header offset, one at a time.
    Returns ``(bytes written, the open shard files)``."""
    import struct

    import torch

    shards, size = [[]], 0
    for name, t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {t.dtype}, not bf16")
        if shards[-1] and size + 2 * t.numel() > CKPT_SHARD_BYTES:
            shards.append([])
            size = 0
        shards[-1].append((name, t))
        size += 2 * t.numel()
    weight_map, written, tensor_bytes, files = {}, 0, 0, []
    for s, shard in enumerate(shards):
        fname = f"model-{s + 1:05d}-of-{len(shards):05d}.safetensors"
        header, offset = {"__metadata__": {"format": "pt"}}, 0
        for name, t in shard:
            header[name] = {"dtype": "BF16", "shape": list(t.shape),
                            "data_offsets": [offset, offset + 2 * t.numel()]}
            offset += 2 * t.numel()
            weight_map[name] = fname
        blob = json.dumps(header).encode()
        blob += b" " * (-len(blob) % 8)
        f = shard_file(out_dir, fname)
        files.append(f)
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, t in shard:
            t.contiguous().view(torch.int16).cpu().numpy().tofile(f)
        f.flush()
        if f.tell() != 8 + len(blob) + offset:
            raise AssertionError(f"{fname}: wrote {f.tell()} bytes")
        written += 8 + len(blob) + offset
        tensor_bytes += offset
    with open(os.path.join(out_dir, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": tensor_bytes},
                   "weight_map": weight_map}, f, indent=1)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    return written, files


def pickle_split(hf_dir, tmp):
    """Seconds to pickle the f32 ``[in, out]`` views of the first
    PICKLE_SPLIT_LAYERS decoder blocks' weights (as ``convert_hf_dir``
    holds them) with its ``_TreePickler`` to /dev/null, to a RAM file and
    to a disk file (flushed by ``fsync``), and with the C pickler
    (``pickle.dump``) to /dev/null. Returns ``(GB, {target: s})``."""
    import pickle

    from mllm_sparse_retrieval_tpu_torch.models.convert import (
        SafetensorsStateDict, _TreePickler)

    sd = SafetensorsStateDict(hf_dir)
    prefix = "language_model.model.layers."
    tree = {k: (a.T if a.ndim == 2 else a) for k in sorted(sd)
            if k.startswith(prefix)
            and int(k[len(prefix):].split(".")[0]) < PICKLE_SPLIT_LAYERS
            for a in (sd[k],)}
    gb = sum(a.nbytes for a in tree.values()) / 1e9
    times = {}

    def timed(label, f, dump):
        t0 = time.monotonic()
        dump(f)
        f.flush()
        if label == "disk":
            os.fsync(f.fileno())
        times[label] = time.monotonic() - t0
        f.close()

    def tree_pickler(f):
        _TreePickler(f, protocol=4).dump(tree)

    timed("null", open(os.devnull, "wb"), tree_pickler)
    timed("ram", os.fdopen(os.memfd_create("split"), "w+b"), tree_pickler)
    disk = os.path.join(tmp, "split.pkl")
    timed("disk", open(disk, "wb"), tree_pickler)
    os.remove(disk)
    timed("c_null", open(os.devnull, "wb"),
          lambda f: pickle.dump(tree, f, protocol=4))
    return gb, times


def phase_checkpoint(spec, card):
    """The main path's model from a checkpoint: LLaVA-NeXT-Llama3-8B drawn
    at full width and depth on the card (bf16), written as an HF llava_next
    checkpoint (its shards in RAM, ``ram_file``; the f32 ``params.pkl`` on
    disk), converted by ``convert_hf_dir`` and loaded by
    ``build_model``; every loaded tensor equal to its drawn one bit for
    bit and the manifest's arch equal to the registry's. Returns
    ``(params, arch)``, the loaded tree."""
    import resource
    import shutil
    import tempfile

    import torch

    from mllm_sparse_retrieval_tpu_torch.configs import ModelConfig
    from mllm_sparse_retrieval_tpu_torch.models import build_model, mllm
    from mllm_sparse_retrieval_tpu_torch.models.convert import (
        arch_from_hf_config, convert_hf_dir)

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    drawn = mllm.init_params(spec.arch, gen, DEVICE, torch.bfloat16)
    want = checksums(drawn)
    config = hf_config(spec.arch)
    if arch_from_hf_config(config) != spec.arch:
        raise AssertionError("the written config.json does not give the "
                             "registry's arch")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    shards = []
    try:
        hf_dir, out_dir = os.path.join(tmp, "hf"), os.path.join(tmp, "conv")
        os.makedirs(hf_dir)
        t0 = time.monotonic()
        tensors = hf_checkpoint_tensors(drawn, spec.arch)
        n_tensors = len(tensors)
        written, shards = write_hf_checkpoint(tensors, config, hf_dir,
                                              ram_file)
        write_s = time.monotonic() - t0
        del tensors, drawn
        torch.cuda.empty_cache()
        progress("checkpoint", f"{spec.arch.text.num_layers}-layer "
                 f"{spec.hf_repo} at full width: {n_tensors} bf16 tensors "
                 f"written from the card as {len(shards)} safetensors "
                 f"shards (in RAM, linked by name), {written / 1e9:.3f} GB "
                 f"in {write_s:.2f} s")
        t0 = time.monotonic()
        convert_hf_dir(hf_dir, out_dir)
        convert_s = time.monotonic() - t0
        pkl_bytes = os.path.getsize(os.path.join(out_dir, "params.pkl"))
        progress("checkpoint", f"convert_hf_dir {convert_s:.2f} s: "
                 f"params.pkl {pkl_bytes / 1e9:.3f} GB f32 on disk")
        split_gb, split = pickle_split(hf_dir, tmp)
        progress("checkpoint", f"pickling {split_gb:.3f} GB of f32 ("
                 f"{PICKLE_SPLIT_LAYERS} decoder blocks): _TreePickler to "
                 + ", to ".join(f"{k} {v:.2f} s ({split_gb / v:.3f} GB/s)"
                                for k, v in split.items() if k != "c_null")
                 + f"; pickle.dump to null {split['c_null']:.2f} s "
                 f"({split_gb / split['c_null']:.3f} GB/s); card {card}")
        t0 = time.monotonic()
        for f in shards:
            f.close()
        params, arch, tok, _ = build_model(ModelConfig(
            family=spec.family, checkpoint_path=out_dir, dtype="bfloat16"),
            device=DEVICE)
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
    finally:
        for f in shards:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    got = checksums(params)
    bad = sorted(str(p) for p in set(want) | set(got)
                 if want.get(p) != got.get(p))
    if bad or arch != spec.arch or tok is not None:
        raise AssertionError(f"loaded checkpoint: {len(bad)} tensors differ "
                             f"from the drawn ones ({bad[:4]}), arch equal "
                             f"{arch == spec.arch}, tokenizer {tok}")
    progress("checkpoint", f"write {write_s:.2f} s, convert_hf_dir "
             f"{convert_s:.2f} s; build_model / load_converted {load_s:.2f} s "
             f"({pkl_bytes / 1e9 / load_s:.3f} GB/s of params.pkl); host "
             f"peak RSS {rss_gb:.2f} GB; device memory after load "
             f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; all "
             f"{len(got)} loaded tensors equal the drawn ones bit for bit, "
             f"arch equal to the registry's; card {card}")
    return params, arch


def phase_families(tok, tmpl, lexicon, index, cmap, card):
    """LLaVA-1.6-Vicuna-7B (anyres, 32 KV heads: the flash forward at
    G = 1) and then LLaVA-1.5-7B (fixed 336 px grid, 576 image tokens:
    prompts under FLASH_MIN_SEQ take plain attention), each drawn at full
    width on the card and freed after use: FAM_QUERIES text and image
    queries through ``RetrievalService``, every result equal to the matmul
    backend's; one TAAT launch per micro-batch; Vicuna takes exactly one
    flash launch per layer and image micro-batch, LLaVA-1.5 none. Returns
    the TAAT and flash launches."""
    import dataclasses

    import numpy as np
    import torch

    from mllm_sparse_retrieval_tpu_torch.configs import (
        ModelFamily, SparseConfig)
    from mllm_sparse_retrieval_tpu_torch.models import mllm
    from mllm_sparse_retrieval_tpu_torch.models.llama import param_count
    from mllm_sparse_retrieval_tpu_torch.models.registry import (
        get_family_spec)
    from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA
    from mllm_sparse_retrieval_tpu_torch.ops import impact_kernel as K
    from mllm_sparse_retrieval_tpu_torch.serving import (
        OnlineQueryEncoder, RetrievalService)

    rng = np.random.default_rng(SEED + 6)
    taat = flash = 0
    for family in (ModelFamily.LLAVA_1_6_VICUNA, ModelFamily.LLAVA_1_5):
        spec = get_family_spec(family)
        arch = dataclasses.replace(spec.arch,
                                   image_token_id=tok.image_token_id)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
        params = mllm.init_params(arch, gen, DEVICE, torch.bfloat16)
        texts = captions(rng, lexicon, FAM_QUERIES, 10, 15)
        images = [rng.integers(0, 256, size=hw + (3,), dtype=np.uint8)
                  .astype(np.float32) / 255.0
                  for hw in IMAGE_SIZES[:FAM_QUERIES]]
        enc = RecordingEncoder(OnlineQueryEncoder(
            params, arch, tok, tmpl, SparseConfig(), max_text_len=64,
            device=DEVICE))
        svc = RetrievalService(impact_index=index, query_encoder=enc,
                               backend="taat", max_batch=MAX_BATCH,
                               depth_levels=(DEPTH,), max_wait_ms=10.0)
        runs = {}
        try:
            svc.search(text=texts[0], timeout=WARMUP_TIMEOUT_S)
            svc.search(image=images[0], timeout=IMAGE_REQUEST_TIMEOUT_S)
            torch.cuda.reset_peak_memory_stats()
            for kind, queries, threads, timeout, deadline in (
                    ("text", texts, N_THREADS, REQUEST_TIMEOUT_S,
                     SERVE_DEADLINE_S),
                    ("image", images, IMAGE_THREADS, IMAGE_REQUEST_TIMEOUT_S,
                     IMAGE_DEADLINE_S)):
                torch.cuda.synchronize()
                batches0 = svc.stats()["batches"]
                enc.tower_s.clear()
                K.reset_launch_count()
                FA.reset_launch_count()
                results, latency, wall = serve(svc, kind, queries, threads,
                                               timeout, deadline)
                runs[kind] = (K.launch_count(), FA.launch_count(),
                              svc.stats()["batches"] - batches0, results,
                              latency, wall, np.mean(enc.tower_s))
        finally:
            svc.close()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prompt = enc._image_state()
        img_len = -(-prompt.get("fixed_len", len(prompt.get("row", ())))
                    // 16) * 16         # the encoder pads to 16s
        per_batch = arch.text.num_layers if arch.anyres else 0
        lines = []
        for kind, run in runs.items():
            k_n, f_n, n_batches, results, latency, wall, enc_s = run
            want_flash = per_batch * n_batches if kind == "image" else 0
            if k_n != n_batches or f_n != want_flash:
                raise AssertionError(
                    f"{spec.hf_repo} {kind}: {k_n} TAAT and {f_n} flash "
                    f"launches in {n_batches} micro-batches, want "
                    f"{n_batches} and {want_flash}")
            keys = texts if kind == "text" else [image_key(im)
                                                 for im in images]
            check_results(index, cmap, [f"{kind} {i}" for i in
                                        range(len(keys))],
                          [enc.terms[q] for q in keys], results)
            taat += k_n
            flash += f_n
            lat = np.array(latency) * 1e3
            lines.append(f"{kind}: {n_batches} micro-batches, TAAT "
                         f"launches {k_n}, flash launches {f_n}, p50 "
                         f"{np.percentile(lat, 50):.2f} ms, "
                         f"{len(keys) / wall:.2f} QPS, encode "
                         f"{enc_s * 1e3:.2f} ms per batch")
        t = arch.text
        progress("families", f"{spec.hf_repo}: {param_count(params):,} bf16"
                 f" weights drawn on the card ({t.num_layers} layers, "
                 f"{t.num_heads}/{t.num_kv_heads} heads, FFN "
                 f"{t.intermediate_size}, vocab {t.vocab_size}, "
                 f"{'anyres' if arch.anyres else 'fixed grid'}), image "
                 f"prompts of {img_len} tokens; " + "; ".join(lines)
                 + f"; all {2 * FAM_QUERIES} results equal the matmul "
                 f"backend's; peak {peak_gb:.2f} GB; card {card}")
        del enc, svc, params
        gc.collect()            # a closed service and its encoder form a
        torch.cuda.empty_cache()  # cycle: free the weights before the next
    return taat, flash


def phase_chat_families(ctok, lexicon, index, cmap, card):
    """InternVL2.5-8B (dynamic tiling, InternViT, 3,584-token image
    prompts through the flash forward at G = 7) and then Qwen2.5-VL-7B
    (the windowed ViT at native resolution, M-RoPE, prompts under
    FLASH_MIN_SEQ), each drawn at full width on the card and freed after
    use: FAM_QUERIES text and image queries through ``RetrievalService``
    with the family's chat template on ``ctok``, every result equal to the
    matmul backend's; one TAAT launch per micro-batch; InternVL2.5 takes
    exactly one flash launch per layer and image micro-batch (28), Qwen
    none; then one image micro-batch's breakdown; then, on the same
    weights, contrastive LoRA training (``phase_chat_train``) and, for
    InternVL2.5, the training and analysis entry points
    (``phase_chat_cli``). Returns the TAAT and flash launches of the served
    runs, the training's flash launches by kernel (the CLI's included) and
    the statistics' flash launches."""
    import numpy as np
    import torch

    from mllm_sparse_retrieval_tpu_torch.configs import SparseConfig
    from mllm_sparse_retrieval_tpu_torch.models import registry
    from mllm_sparse_retrieval_tpu_torch.models.internvl import (
        InternVLConfig)
    from mllm_sparse_retrieval_tpu_torch.models.llama import param_count
    from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA
    from mllm_sparse_retrieval_tpu_torch.ops import impact_kernel as K
    from mllm_sparse_retrieval_tpu_torch.serving import (
        OnlineQueryEncoder, RetrievalService)

    rng = np.random.default_rng(SEED + 7)
    taat = flash = stats_flash = 0
    trained = dict.fromkeys(FA.KERNELS, 0)
    for name, arch, tmpl in chat_family_archs(ctok):
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
        params = registry.init_params(arch, gen, DEVICE, torch.bfloat16)
        texts = captions(rng, lexicon, FAM_QUERIES, 10, 15)
        images = [rng.integers(0, 256, size=hw + (3,), dtype=np.uint8)
                  .astype(np.float32) / 255.0
                  for hw in IMAGE_SIZES[:FAM_QUERIES]]
        enc = RecordingEncoder(OnlineQueryEncoder(
            params, arch, ctok, tmpl, SparseConfig(), max_text_len=64,
            device=DEVICE))
        svc = RetrievalService(impact_index=index, query_encoder=enc,
                               backend="taat", max_batch=MAX_BATCH,
                               depth_levels=(DEPTH,), max_wait_ms=10.0)
        runs = {}
        try:
            svc.search(text=texts[0], timeout=WARMUP_TIMEOUT_S)
            svc.search(image=images[0], timeout=IMAGE_REQUEST_TIMEOUT_S)
            torch.cuda.reset_peak_memory_stats()
            for kind, queries, threads, timeout, deadline in (
                    ("text", texts, N_THREADS, REQUEST_TIMEOUT_S,
                     SERVE_DEADLINE_S),
                    ("image", images, IMAGE_THREADS, IMAGE_REQUEST_TIMEOUT_S,
                     IMAGE_DEADLINE_S)):
                torch.cuda.synchronize()
                batches0 = svc.stats()["batches"]
                enc.tower_s.clear()
                K.reset_launch_count()
                FA.reset_launch_count()
                results, latency, wall = serve(svc, kind, queries, threads,
                                               timeout, deadline)
                runs[kind] = (K.launch_count(), FA.launch_count(),
                              svc.stats()["batches"] - batches0, results,
                              latency, wall, np.mean(enc.tower_s))
        finally:
            svc.close()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        img_len = -(-enc._image_state()["fixed_len"] // 16) * 16  # padded
        per_batch = (arch.text.num_layers if isinstance(arch, InternVLConfig)
                     else 0)
        lines = []
        for kind, run in runs.items():
            k_n, f_n, n_batches, results, latency, wall, enc_s = run
            want_flash = per_batch * n_batches if kind == "image" else 0
            if k_n != n_batches or f_n != want_flash:
                raise AssertionError(
                    f"{name} {kind}: {k_n} TAAT and {f_n} flash launches in "
                    f"{n_batches} micro-batches, want {n_batches} and "
                    f"{want_flash}")
            keys = texts if kind == "text" else [image_key(im)
                                                 for im in images]
            check_results(index, cmap, [f"{name} {kind} {i}"
                                        for i in range(len(keys))],
                          [enc.terms[q] for q in keys], results)
            taat += k_n
            flash += f_n
            lat = np.array(latency) * 1e3
            lines.append(f"{kind}: {n_batches} micro-batches, TAAT "
                         f"launches {k_n}, flash launches {f_n}, p50 "
                         f"{np.percentile(lat, 50):.2f} ms, "
                         f"{len(keys) / wall:.2f} QPS, encode "
                         f"{enc_s * 1e3:.2f} ms per batch")
        t, v = arch.text, arch.vision
        tower = (f"InternViT {v.num_layers} layers x {v.hidden_size}, "
                 f"{arch.max_dynamic_tiles + 1} tiles of {v.image_size} px"
                 if isinstance(arch, InternVLConfig) else
                 f"windowed ViT {v.depth} blocks x {v.hidden_size}, "
                 f"{arch.padded_window_units * v.merge_unit} padded patches"
                 f" an image, M-RoPE {t.mrope_section}")
        progress("chat_families", f"{name}: {param_count(params):,} bf16 "
                 f"weights drawn on the card ({t.num_layers} layers, "
                 f"{t.num_heads}/{t.num_kv_heads} heads, FFN "
                 f"{t.intermediate_size}, vocab {t.vocab_size}; {tower}), "
                 f"image prompts of {img_len} tokens; " + "; ".join(lines)
                 + f"; all {2 * FAM_QUERIES} results equal the matmul "
                 f"backend's; peak {peak_gb:.2f} GB; card {card}")
        torch.cuda.reset_peak_memory_stats()
        image_breakdown(enc, images[:MAX_BATCH], flash=per_batch > 0,
                        label=f"{name}: ", iters=1)
        progress("chat_families", f"{name}: breakdown peak "
                 f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del enc, svc
        gc.collect()            # a closed service and its encoder form a
        torch.cuda.empty_cache()  # cycle: free them before training
        launched = [phase_chat_train(name, params, arch, tmpl, ctok, lexicon,
                                     card)]
        if isinstance(arch, InternVLConfig):
            cli_train, cli_stats = phase_chat_cli(params, arch, tmpl, ctok,
                                                  lexicon, card)
            launched.append(cli_train)
            stats_flash += cli_stats
        for counts in launched:
            for k in FA.KERNELS:
                trained[k] += counts[k]
        del params
        gc.collect()
        torch.cuda.empty_cache()  # free the weights before the next family
    return taat, flash, trained, stats_flash


def hostops_check(dense_run, sparse_run):
    """``hostops`` on the offline phase's text->image runs: the C run
    assembly (``make_run`` on the runs' rows as lists) and the C fusion
    (``fuse`` of the two runs) equal to their Python bodies, and each C
    function counted once. Returns the number of queries."""
    from mllm_sparse_retrieval_tpu_torch import hostops
    from mllm_sparse_retrieval_tpu_torch.search import fusion, runs

    both = [dense_run.materialize(), sparse_run.materialize()]
    hostops.reset_call_counts()
    for label, run in (("dense", dense_run), ("sparse", sparse_run)):
        rows = list(run.iter_ranked())
        qids = [q for q, _, _ in rows]
        scores = [[float(x) for x in s] for _, s, _ in rows]
        ids = [[str(d) for d in i] for _, _, i in rows]
        got = runs.make_run(qids, scores, ids, scores_sorted=True)
        if got != runs._make_run_python(qids, scores, ids, False, True):
            raise AssertionError(f"hostops: the {label} run differs from "
                                 f"make_run's Python body")
    weights = [OFF_ALPHA, 1 - OFF_ALPHA]
    if fusion.fuse(both, weights) != fusion._fuse_python(both, weights):
        raise AssertionError("hostops: the fused run differs from fuse's "
                             "Python body")
    counts = hostops.call_counts()
    if counts["build_runs"] != 2 or counts["fuse_runs"] != 1:
        raise AssertionError(f"hostops: calls {counts}, want 2 build_runs "
                             f"and 1 fuse_runs")
    return len(both[0])


def chat_train_sizes(n):
    """Image sizes of the chat-family training pairs (the training
    phase's cycle through ``IMAGE_SIZES``)."""
    return [IMAGE_SIZES[(3 * i) % len(IMAGE_SIZES)] for i in range(n)]


def phase_chat_train(name, params, arch, tmpl, ctok, lexicon, card):
    """Contrastive LoRA training of a chat-template family at full width:
    ``CHAT_TRAIN_STEPS`` steps of ``ContrastiveTrainer.train_on_batch`` on
    ``TRAIN_B`` seeded image-caption pairs each (LoRA r=8 on the text
    tower, dropout 0.1, remat), with their step host ms, device ms (CUDA
    events) and peak memory. InternVL2.5: 13-tile image prompts of 3,584
    tokens through the flash kernels, 2 x 28 forward launches a step (the
    remat recompute included) and 28 dq and 28 dkv, then the flash-vs-
    plain gradient cosine (``grad_check``). Qwen2.5-VL: native-resolution
    prompts under ``FLASH_MIN_SEQ``, no launch, every batch with ``[3, B,
    T]`` M-RoPE ids. Returns the steps' flash launches by kernel."""
    import numpy as np
    import torch

    from mllm_sparse_retrieval_tpu_torch.configs import TrainConfig
    from mllm_sparse_retrieval_tpu_torch.data.karpathy import Example
    from mllm_sparse_retrieval_tpu_torch.models import lora
    from mllm_sparse_retrieval_tpu_torch.models.internvl import (
        InternVLConfig)
    from mllm_sparse_retrieval_tpu_torch.models.layers import FLASH_MIN_SEQ
    from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA
    from mllm_sparse_retrieval_tpu_torch.train.trainer import (
        ContrastiveTrainer, make_collator)

    n = TRAIN_B * CHAT_TRAIN_STEPS
    rng = np.random.default_rng(SEED + 8)
    raw = {f"i{i}": rng.integers(0, 256, size=hw + (3,), dtype=np.uint8)
           .astype(np.float32) / 255.0
           for i, hw in enumerate(chat_train_sizes(n))}
    examples = [Example(c, f"/nonexistent/chat_{i}.jpg", f"t{i}", f"i{i}")
                for i, c in enumerate(captions(rng, lexicon, n, 8, 14))]
    collate = make_collator(ctok, tmpl, arch,
                            pixel_loader=lambda e: raw[e.img_id])
    t0 = time.monotonic()
    batches = [collate(examples[i * TRAIN_B:(i + 1) * TRAIN_B])
               for i in range(CHAT_TRAIN_STEPS)]
    collate_s = (time.monotonic() - t0) / CHAT_TRAIN_STEPS
    layers = arch.text.num_layers
    internvl = isinstance(arch, InternVLConfig)
    if internvl:
        want = {"fwd": 2 * layers, "dq": layers, "dkv": layers}
        shape = (TRAIN_B, arch.max_dynamic_tiles + 1,
                 arch.vision.image_size, arch.vision.image_size, 3)
        for b in batches:
            if b.pixels.shape != shape or b.image_pos_ids is not None \
                    or b.image_ids.shape[1] < FLASH_MIN_SEQ:
                raise AssertionError(f"{name}: tiles {b.pixels.shape}, "
                                     f"prompts {b.image_ids.shape}")
    else:
        want = dict.fromkeys(FA.KERNELS, 0)
        for b in batches:
            if b.image_pos_ids is None or b.image_pos_ids.shape != (
                    (3,) + b.image_ids.shape) or \
                    b.image_ids.shape[1] >= FLASH_MIN_SEQ or not (
                        b.image_pos_ids[1] != b.image_pos_ids[2]).any():
                raise AssertionError(
                    f"{name}: M-RoPE ids "
                    f"{getattr(b.image_pos_ids, 'shape', None)} for image "
                    f"prompts {b.image_ids.shape}")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    adapters = lora.init_lora(gen, params, arch, rank=LORA_RANK,
                              alpha=LORA_ALPHA, device=DEVICE)
    cfg = TrainConfig(learning_rate=TRAIN_LR, tau=TAU, lora_rank=LORA_RANK,
                      lora_alpha=LORA_ALPHA, lora_dropout=LORA_DROPOUT,
                      remat=True, seed=SEED)
    trainer = ContrastiveTrainer(params, arch, adapters, cfg, device=DEVICE)
    start = [x.detach().clone() for x in lora.tree_leaves(adapters)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total = dict.fromkeys(FA.KERNELS, 0)
    losses = []
    for i, batch in enumerate(batches):
        before = {k: FA.launch_count(k) for k in FA.KERNELS}
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t_step = time.monotonic()
        begin.record()
        loss = trainer.train_on_batch(batch)
        end.record()
        torch.cuda.synchronize()
        host = (time.monotonic() - t_step) * 1e3
        dev = begin.elapsed_time(end)
        launched = {k: FA.launch_count(k) - before[k] for k in FA.KERNELS}
        if launched != want:
            raise AssertionError(f"{name} step {i}: flash launches "
                                 f"{launched}, want {want}")
        for k in FA.KERNELS:
            total[k] += launched[k]
        losses.append(loss)
        progress("chat_train", f"{name} step {i}: loss {loss:.5f}, host "
                 f"{host:.1f} ms, device {dev:.1f} ms, image prompts "
                 f"{batch.image_ids.shape[1]} tokens, captions "
                 f"{batch.text_ids.shape[1]}; flash launches {launched}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    moved = max(float((x.detach() - y).abs().max())
                for x, y in zip(lora.tree_leaves(adapters), start))
    if not all(np.isfinite(losses)) or not moved > 0:
        raise AssertionError(f"{name} training: losses {losses}, adapters "
                             f"moved {moved}")
    extra = ("[3, B, T] M-RoPE ids in every batch" if not internvl else
             f"{shape[1]} tiles of {shape[2]} px an image")
    progress("chat_train", f"{name}: {CHAT_TRAIN_STEPS} steps of {TRAIN_B} "
             f"pairs, LoRA r={LORA_RANK} on "
             f"{len(lora.tree_leaves(adapters)) // 3} projections, dropout "
             f"{LORA_DROPOUT}, remat; {extra}; host collate "
             f"{collate_s * 1e3:.1f} ms per batch; peak {peak:.2f} GB; "
             f"adapters moved by up to {moved:.3g}; launches {total}; card "
             f"{card}")
    if internvl:
        grad_check(trainer, batches[0])
    del trainer, adapters, start, batches
    gc.collect()
    torch.cuda.empty_cache()
    return total


def write_karpathy_json(path, rng, lexicon):
    """A seeded Karpathy ``dataset.json`` of ``CLI_IMAGES`` images (absent
    files) with ``OFF_CAPS`` captions each, split train / restval / val /
    test in turn."""
    images, sent = [], 0
    for i in range(CLI_IMAGES):
        caps = captions(rng, lexicon, OFF_CAPS, 8, 14)
        images.append({"imgid": i, "filename": f"cli_{i}.jpg",
                       "split": ("train", "restval", "val", "test")[i % 4],
                       "sentences": [{"raw": c, "sentid": sent + j}
                                     for j, c in enumerate(caps)]})
        sent += len(caps)
    with open(path, "w") as f:
        json.dump({"images": images}, f)


def phase_chat_cli(params, arch, tmpl, ctok, lexicon, card):
    """The training and analysis entry points on InternVL2.5-8B at full
    width: ``cli.prepare_data`` split, few-shot and check on a seeded
    Karpathy JSON; ``cli.train.run`` (the CLI's body) for one epoch on the
    ``CLI_PAIRS`` few-shot pairs at batch ``TRAIN_B`` with remat, the
    ``lora.pkl`` it writes loaded back and held to its adapters; then
    ``term_weight_statistics`` of the trained model (the adapters from that
    file) on those images and their captions. Returns the flash launches of
    the training (by kernel) and of the statistics."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from mllm_sparse_retrieval_tpu_torch.cli import prepare_data
    from mllm_sparse_retrieval_tpu_torch.cli import train as train_cli
    from mllm_sparse_retrieval_tpu_torch.configs import SparseConfig
    from mllm_sparse_retrieval_tpu_torch.data import CrossModalCorpus
    from mllm_sparse_retrieval_tpu_torch.eval.statistics import (
        term_weight_statistics)
    from mllm_sparse_retrieval_tpu_torch.models import lora
    from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA

    layers = arch.text.num_layers
    with tempfile.TemporaryDirectory() as tmp:
        write_karpathy_json(os.path.join(tmp, "dataset.json"),
                            np.random.default_rng(SEED + 10), lexicon)
        data = os.path.join(tmp, "flickr")
        few = os.path.join(data, f"flickr_train_{CLI_PAIRS}.csv")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            prepare_data.main(["split", "--json",
                               os.path.join(tmp, "dataset.json"),
                               "--out-dir", data, "--dataset", "flickr"])
            prepare_data.main(["few-shot", "--train-csv",
                               os.path.join(data, "flickr_train.csv"),
                               "--out-csv", few, "--num-images",
                               str(CLI_PAIRS)])
            prepare_data.main(["check", "--csv", few])
        printed = out.getvalue().splitlines()
        want = [f"{split}\t{os.path.join(data, f'flickr_{split}.csv')}"
                for split in ("train", "val", "test")] + [
            f"{few}\t{CLI_PAIRS * OFF_CAPS} rows",
            f"{OFF_CAPS} captions: {CLI_PAIRS} images"]
        if printed != want:
            raise AssertionError(f"cli.prepare_data printed {printed}")
        args = train_cli.build_parser().parse_args([
            "--dataset", "flickr", "--data-root", tmp, "--few-shot-sum",
            str(CLI_PAIRS), "--batch-size", str(TRAIN_B), "--num-epochs",
            "1", "--learning-rate", str(TRAIN_LR), "--tau", str(TAU),
            "--lora-rank", str(LORA_RANK), "--lora-alpha", str(LORA_ALPHA),
            "--lora-dropout", str(LORA_DROPOUT), "--remat", "--log-every",
            "1", "--output-dir", os.path.join(tmp, "out"), "--device",
            DEVICE])
        before = {k: FA.launch_count(k) for k in FA.KERNELS}
        torch.cuda.synchronize()
        t0 = time.monotonic()
        path, trainer = train_cli.run(args, model=(params, arch, ctok, tmpl))
        torch.cuda.synchronize()
        train_s = time.monotonic() - t0
        train = {k: FA.launch_count(k) - before[k] for k in FA.KERNELS}
        steps = CLI_PAIRS // TRAIN_B
        if train != {"fwd": 2 * layers * steps, "dq": layers * steps,
                     "dkv": layers * steps}:
            raise AssertionError(f"cli.train: flash launches {train} in "
                                 f"{steps} steps")
        saved = lora.load_lora(path, DEVICE)
        mine = lora.tree_leaves(trainer.adapters)
        theirs = lora.tree_leaves(saved)
        if path != os.path.join(tmp, "out", "lora.pkl") or \
                len(mine) != len(theirs) or not all(
                    torch.equal(a.detach(), b) for a, b in zip(mine, theirs)):
            raise AssertionError(f"cli.train: {path} does not hold the "
                                 f"trained adapters")
        losses = trainer.loss_history
        if len(losses) != steps or not all(np.isfinite(losses)):
            raise AssertionError(f"cli.train: losses {losses}")
        del trainer, mine, theirs
        gc.collect()
        torch.cuda.empty_cache()
        progress("chat_cli", f"InternVL2.5-8B: cli.prepare_data split / "
                 f"few-shot / check ({CLI_PAIRS} of {CLI_IMAGES // 2} train "
                 f"images, {CLI_PAIRS * OFF_CAPS} rows); cli.train.run one "
                 f"epoch, {steps} steps of {TRAIN_B} pairs in {train_s:.1f} "
                 f"s, losses {[round(x, 5) for x in losses]}, flash "
                 f"launches {train}; {os.path.basename(path)} "
                 f"({os.path.getsize(path):,} bytes) loads back equal to "
                 f"the trained adapters")

        corpus = CrossModalCorpus("flickr", "train", tmp,
                                  few_shot_sum=CLI_PAIRS)
        n_caps = sum(len(corpus.img2text[e.img_id])
                     for e in corpus.examples_single())
        fwd0 = FA.launch_count("fwd")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        stats = term_weight_statistics(
            corpus, params, arch, ctok, tmpl, sparse_cfg=SparseConfig(),
            num_images=CLI_PAIRS, batch_size=MAX_BATCH, lora=saved,
            device=DEVICE)
        stats_s = time.monotonic() - t0
        stats_flash = FA.launch_count("fwd") - fwd0
    v = ctok.vocab_size
    sizes = (stats.image_in_text.size + stats.image_out_text.size,
             stats.text_in_text.size + stats.text_out_text.size)
    arrays = (stats.image_in_text, stats.image_out_text, stats.text_in_text,
              stats.text_out_text)
    if sizes != (CLI_PAIRS * v, n_caps * v) or not all(
            np.isfinite(a).all() and (a >= 0).all() for a in arrays) or \
            stats_flash != layers * -(-CLI_PAIRS // MAX_BATCH):
        raise AssertionError(f"term_weight_statistics: sizes {sizes}, want "
                             f"{(CLI_PAIRS * v, n_caps * v)}; flash "
                             f"launches {stats_flash}")
    progress("chat_cli", f"InternVL2.5-8B trained: term_weight_statistics "
             f"of {CLI_PAIRS} images and {n_caps} captions in "
             f"{stats_s:.1f} s (flash launches {stats_flash}, peak "
             f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB): "
             f"{stats.summary()}; card {card}")
    return train, stats_flash


def same_up_to_ties(got, want, depth=DEPTH):
    """Equal (doc, score) sets, except for docs tied at the depth cut."""
    g, w = set(got), set(want)
    if sorted(s for _, s in g) != sorted(s for _, s in w):
        return False
    if len(got) < depth:
        return g == w
    cut = min(s for _, s in g)
    return {x for x in g if x[1] > cut} == {x for x in w if x[1] > cut}


def main() -> int:
    import dataclasses

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2
    from mllm_sparse_retrieval_tpu_torch import hostops
    from mllm_sparse_retrieval_tpu_torch.configs import (
        ModelFamily, SparseConfig)
    from mllm_sparse_retrieval_tpu_torch.eval.statistics import (
        fusion_provenance_statistics)
    from mllm_sparse_retrieval_tpu_torch.index import ImpactIndex
    from mllm_sparse_retrieval_tpu_torch.models import anyres, templates
    from mllm_sparse_retrieval_tpu_torch.models.layers import FLASH_MIN_SEQ
    from mllm_sparse_retrieval_tpu_torch.models.llama import param_count
    from mllm_sparse_retrieval_tpu_torch.models.registry import (
        get_family_spec)
    from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
        WordPieceLiteTokenizer)
    from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA
    from mllm_sparse_retrieval_tpu_torch.ops import impact_kernel as K
    from mllm_sparse_retrieval_tpu_torch.ops.impact_kernel import (
        prepare_query_arrays)
    from mllm_sparse_retrieval_tpu_torch.search.fusion import fuse
    from mllm_sparse_retrieval_tpu_torch.serving import (
        OnlineQueryEncoder, RetrievalService)
    from mllm_sparse_retrieval_tpu_torch.sparse import (
        SelectedTerms, canonical_id_map)

    # ---- 0. device -------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = smi()
    progress("device", f"{kind} x{count}; nvidia-smi: {card}; torch "
             f"{torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. build --------------------------------------------------------
    build_kernels()

    # ---- 2. TAAT kernel at the benchmark shape ------------------------------
    rng = np.random.default_rng(SEED)
    bench = phase_kernel_bench(rng)

    # ---- 3. tokenizer, and the flash kernel at the served image shape -------
    lexicon = synthetic_lexicon(rng, VOCAB_WORDS)
    tok = WordPieceLiteTokenizer.from_corpus_captions(
        captions(rng, lexicon, 20_000, 8, 14), vocab_size=VOCAB_WORDS)
    vocab = tok.get_vocab()
    word_ids = np.array(sorted(i for p, i in vocab.items()
                               if p.startswith("▁") and len(p) > 2))
    progress("slice", f"tokenizer: {tok.vocab_size} pieces, "
             f"{word_ids.size} word pieces")
    spec = get_family_spec(ModelFamily.LLAVA_NEXT_LLAMA3)
    # the synthetic tokenizer has no Llama-3 chat specials: prompts use the
    # plain-text wrapper of the tiny family, and image slots the tokenizer's
    # own <image> id; every width of the model is unchanged
    tmpl = templates.TINY
    arch_img = dataclasses.replace(spec.arch,
                                   image_token_id=tok.image_token_id)
    image_prompt_len = [len(tok.encode(tmpl.expand_image(
        tmpl.image_prompt(), anyres.num_image_tokens(
            size, arch_img.grid_pinpoints, arch_img.vision.image_size,
            arch_img.patches_per_side)))) for size in IMAGE_SIZES]
    fixed_len = len(tok.encode(tmpl.expand_image(
        tmpl.image_prompt(), arch_img.max_image_tokens)))
    seq = -(-fixed_len // 512) * 512 if fixed_len >= FLASH_MIN_SEQ \
        else fixed_len
    # the kernels at the synthetic shapes (one all-pad row; the kernels
    # line reports these) and at the rows of the profiled training step
    # (four real image prompts, no all-pad row)
    train_lengths = [image_prompt_len[(3 * i) % len(IMAGE_SIZES)]
                     for i in range((TRAIN_STEPS - 1) * TRAIN_B,
                                    TRAIN_STEPS * TRAIN_B)]
    flash = phase_flash(image_prompt_len[:FLASH_B - 1] + [0], seq)
    phase_flash(train_lengths, seq)
    # LLaVA-1.6-Vicuna's image shape: its 32 KV heads give G = 1
    phase_flash(image_prompt_len[:FLASH_B - 1] + [0], seq, VICUNA_HEADS,
                VICUNA_HEADS)
    dq_kernel, dkv_kernel = phase_flash_bwd(
        image_prompt_len[:TRAIN_B - 1] + [0], seq)
    phase_flash_bwd(train_lengths, seq)
    # InternVL2.5-8B's image shape: 28 query heads on 4 KV heads (G = 7),
    # prompts of 13 tiles padded to 3,584 tokens
    ctok = ChatTokenizer(tok)
    _, internvl_arch, internvl_tmpl = chat_family_archs(ctok)[0]
    internvl_len, internvl_seq = internvl_prompt_lengths(
        ctok, internvl_arch, internvl_tmpl, IMAGE_SIZES[:FLASH_B - 1])
    flash_g7 = phase_flash(internvl_len + [0], internvl_seq,
                           *INTERNVL_HEADS)
    # and its backward at the chat-family training shape: the first
    # training batch's prompt lengths, one all-pad row
    train_g7, _ = internvl_prompt_lengths(
        ctok, internvl_arch, internvl_tmpl, chat_train_sizes(TRAIN_B - 1))
    dq_g7, dkv_g7 = phase_flash_bwd(train_g7 + [0], internvl_seq,
                                    *INTERNVL_HEADS)

    # ---- 4. the model, from a checkpoint, and the index -----------------------
    params, arch = phase_checkpoint(spec, card)
    t, v = arch.text, arch.vision
    vis = param_count(params) - param_count(params["text"])
    progress("slice", f"LLaVA-NeXT-Llama3-8B: {param_count(params['text']):,}"
             f" bf16 text-tower weights ({t.num_layers} layers, hidden "
             f"{t.hidden_size}, {t.num_heads}/{t.num_kv_heads} heads, FFN "
             f"{t.intermediate_size}, vocab {t.vocab_size}) and {vis:,} of "
             f"ViT ({v.num_layers} layers, hidden {v.hidden_size}, "
             f"{v.num_heads} heads, {v.image_size} px / {v.patch_size}), "
             f"projector and image_newline, loaded from the converted "
             f"checkpoint; {torch.cuda.memory_allocated() / 1e9:.2f} GB "
             f"allocated")

    p = zipf_p(word_ids.size)
    doc_tok = rng.choice(word_ids, size=(N_DOCS, DOC_K), p=p)
    doc_w = rng.integers(1, 350, size=(N_DOCS, DOC_K))
    cmap = canonical_id_map(vocab, True)
    index = ImpactIndex.from_selected_terms(
        [f"doc{i}" for i in range(N_DOCS)],
        [SelectedTerms(a.astype(np.int32), w.astype(np.int32))
         for a, w in zip(doc_tok, doc_w)],
        canonical_map=cmap, device=DEVICE)
    progress("slice", f"impact index: {index.num_docs} docs x {DOC_K} "
             f"terms, {index.num_terms} distinct terms, int16 exact: "
             f"{index._int16_exact()}")

    # ---- 5. text queries through the service ----------------------------------
    hostops.reset_call_counts()
    sparse_cfg = SparseConfig()
    encoder = RecordingEncoder(OnlineQueryEncoder(
        params, arch, tok, tmpl, sparse_cfg, max_text_len=64,
        device=DEVICE))
    svc = RetrievalService(impact_index=index, query_encoder=encoder,
                           backend="taat", max_batch=MAX_BATCH,
                           depth_levels=(DEPTH,), max_wait_ms=10.0)
    texts = captions(rng, lexicon, N_QUERIES, 10, 15)
    try:
        # warm-up: first cuBLAS / allocator use and the device matrix
        svc.search(text=texts[0], timeout=WARMUP_TIMEOUT_S)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        encoder.tower_s.clear()
        batches0 = svc.stats()["batches"]
        K.reset_launch_count()
        FA.reset_launch_count()
        results, latency, wall = serve(svc, "text", texts, N_THREADS,
                                       REQUEST_TIMEOUT_S, SERVE_DEADLINE_S)
        text_taat, text_flash = K.launch_count(), FA.launch_count()
        stats = svc.stats()
    finally:
        svc.close()

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lat_ms = np.array(latency) * 1e3
    sparse_lines = {"text": latency_line(latency, N_QUERIES, wall)}
    progress("slice", f"served {N_QUERIES} text queries from {N_THREADS} "
             f"threads in {stats['batches'] - batches0} micro-batches; "
             f"TAAT launches {text_taat}, flash launches {text_flash}; "
             f"p50 {np.percentile(lat_ms, 50):.2f} ms, p99 "
             f"{np.percentile(lat_ms, 99):.2f} ms, "
             f"{N_QUERIES / wall:.2f} QPS; tower+select "
             f"{np.mean(encoder.tower_s) * 1e3:.2f} ms per batch; peak "
             f"{peak_gb:.2f} GB; card {card}")
    if text_taat < 1:
        raise AssertionError("the served path never launched the TAAT kernel")
    served_terms = [encoder.terms[q] for q in texts]
    check_results(index, cmap, [repr(q) for q in texts], served_terms,
                  results)
    progress("slice", f"all {N_QUERIES} results equal the matmul backend's")

    # ---- 6. the TAAT kernel at the served text shape, text breakdown --------
    q_idx, q_w = index.encode_query_terms(served_terms[:MAX_BATCH], cmap)
    safe_idx, safe_w = (torch.from_numpy(a).to(DEVICE)
                        for a in prepare_query_arrays(q_idx, q_w))
    matrix = index._materialize("i16")
    served = check_kernel(
        f"served shape {tuple(matrix.shape)} int16, B={q_idx.shape[0]} "
        f"Q={q_idx.shape[1]}", matrix, safe_idx, safe_w, iters=200,
        floor=True)
    breakdown(encoder, index, q_idx, q_w, texts[:MAX_BATCH])

    # ---- 7. image queries through the service ---------------------------------
    img_rng = np.random.default_rng(SEED + 2)
    sizes = [IMAGE_SIZES[i % len(IMAGE_SIZES)] for i in range(N_IMAGES)]
    images = [img_rng.integers(0, 256, size=hw + (3,), dtype=np.uint8)
              .astype(np.float32) / 255.0 for hw in sizes]
    img_encoder = RecordingEncoder(OnlineQueryEncoder(
        params, arch_img, tok, tmpl, sparse_cfg, device=DEVICE))
    progress("image", f"{N_IMAGES} seeded uint8 images of sizes "
             f"{sorted(set(sizes))}; prompts padded to {seq} tokens "
             f"(longest {fixed_len}); image token id {arch_img.image_token_id}"
             f" (the synthetic tokenizer's <image>; the checkpoint's is "
             f"{spec.arch.image_token_id}), {arch_img.max_tiles} tiles of "
             f"{arch_img.vision.image_size} px per image")
    svc = RetrievalService(impact_index=index, query_encoder=img_encoder,
                           backend="taat", max_batch=MAX_BATCH,
                           depth_levels=(DEPTH,), max_wait_ms=10.0)
    try:
        svc.search(image=images[0], timeout=IMAGE_REQUEST_TIMEOUT_S)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        img_encoder.tower_s.clear()
        batches0 = svc.stats()["batches"]
        K.reset_launch_count()
        FA.reset_launch_count()
        img_results, img_latency, img_wall = serve(
            svc, "image", images, IMAGE_THREADS, IMAGE_REQUEST_TIMEOUT_S,
            IMAGE_DEADLINE_S)
        img_taat, img_flash = K.launch_count(), FA.launch_count()
        stats = svc.stats()
    finally:
        svc.close()
    img_batches = stats["batches"] - batches0
    img_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lat_ms = np.array(img_latency) * 1e3
    sparse_lines["image"] = latency_line(img_latency, N_IMAGES, img_wall)
    progress("image", f"served {N_IMAGES} image queries from "
             f"{IMAGE_THREADS} threads in {img_batches} micro-batches "
             f"(device batch {MAX_BATCH}); flash launches {img_flash}, TAAT "
             f"launches {img_taat}; p50 {np.percentile(lat_ms, 50):.2f} ms, "
             f"p99 {np.percentile(lat_ms, 99):.2f} ms, "
             f"{N_IMAGES / img_wall:.3f} images/s; encode_images "
             f"{np.mean(img_encoder.tower_s) * 1e3:.2f} ms per batch; peak "
             f"{img_peak_gb:.2f} GB; card {card}")
    if img_flash < 1 or img_flash != arch_img.text.num_layers * img_batches:
        raise AssertionError(f"{img_flash} flash launches in {img_batches} "
                             f"image micro-batches")
    if img_taat < 1:
        raise AssertionError("the image path never launched the TAAT kernel")
    check_results(index, cmap, [f"image {i} {hw}" for i, hw in
                                enumerate(sizes)],
                  [img_encoder.terms[image_key(im)] for im in images],
                  img_results)
    progress("image", f"all {N_IMAGES} results equal the matmul backend's")

    # ---- 8. the whole tower, flash against plain attention; breakdown -------
    tower_flash_check(img_encoder, params, arch_img,
                      images[:TOWER_CHECK_B])
    image_breakdown(img_encoder, images[:MAX_BATCH])
    del img_encoder, encoder
    torch.cuda.empty_cache()

    # ---- 9. hybrid dense + sparse serving ------------------------------------
    hyb_taat, hyb_flash, dense_host = phase_hybrid(
        params, arch, arch_img, tok, tmpl, index, cmap, texts, images,
        sparse_lines, card)

    # ---- 10. search tiers: compact48, streams, SQ8, ANN, explain ----------
    tier_taat = phase_tiers(params, arch, tok, tmpl, lexicon, index,
                            cmap, texts, dense_host, card)

    # ---- 10b. live indexes and the HTTP front end ------------------------
    serve_ops = hostops.call_counts()
    hostops.reset_call_counts()
    live_taat, live_flash = phase_live(params, arch, arch_img, tok, tmpl,
                                       index, cmap, texts, dense_host,
                                       word_ids, card)
    del dense_host
    live_ops = hostops.call_counts()
    if not live_ops["merge_topk_rows"]:
        raise AssertionError(f"the live segments' host merge did not go "
                             f"through hostops: {live_ops}")

    # ---- 11. offline evaluation: corpus -> encode -> indexes -> search -----
    hostops.reset_call_counts()
    off_taat, off_flash, off_runs = phase_offline(params, arch_img, tok,
                                                  tmpl, lexicon, card)
    off_ops = hostops.call_counts()
    if not (off_ops["build_runs"] and off_ops["fuse_runs"]):
        raise AssertionError(f"the offline phase's runs and fusion did not "
                             f"go through hostops: {off_ops}")
    n_fused = hostops_check(*off_runs)
    prov = fusion_provenance_statistics(*off_runs, alpha=OFF_ALPHA,
                                        top_n=OFF_DEPTH)
    ranked = sum(min(OFF_DEPTH, len(docs)) for docs in
                 fuse([r.materialize() for r in off_runs],
                      [OFF_ALPHA, 1 - OFF_ALPHA]).values())
    n_prov = prov.dense_ranks.size + prov.sparse_ranks.size \
        + prov.fused_ranks.size
    if n_prov != ranked:
        raise AssertionError(f"fusion_provenance_statistics ranked {n_prov} "
                             f"docs of {ranked}")
    progress("hostops", f"C calls that gave their callers the result: text "
             f"to tiers phases {serve_ops}; live phase {live_ops}; offline "
             f"phase {off_ops}; on the offline "
             f"text->image runs ({n_fused} queries) make_run and fuse equal "
             f"their Python bodies; fusion_provenance_statistics (top "
             f"{OFF_DEPTH}): {prov.summary()}")
    torch.cuda.empty_cache()

    # ---- 12. contrastive LoRA training; flash against plain gradients --------
    trainer, batches, train_launches = phase_train(
        params, arch_img, tok, tmpl, lexicon, rng, seq)
    grad_check(trainer, batches[0])
    del trainer, batches, params, svc
    gc.collect()                # the closed services still hold the weights
    torch.cuda.empty_cache()

    # ---- 13. LLaVA-1.6-Vicuna-7B and LLaVA-1.5-7B at full width ------------
    fam_taat, fam_flash = phase_families(tok, tmpl, lexicon, index, cmap,
                                         card)

    # ---- 14. InternVL2.5-8B and Qwen2.5-VL-7B at full width ---------------
    chat_taat, chat_flash, chat_train, stats_flash = phase_chat_families(
        ctok, lexicon, index, cmap, card)

    max_err = max(bench["i16"]["max_abs_err"], bench["f32"]["max_abs_err"],
                  served["max_abs_err"])
    kernels = [
        dict(name="taat_impact", route="cuda",
             source="mllm_sparse_retrieval_tpu_torch/csrc/taat.cu",
             replaces="mllm_sparse_retrieval_tpu/ops/impact_kernel.py:115",
             launches=text_taat + img_taat + hyb_taat + tier_taat
             + live_taat + off_taat + fam_taat + chat_taat,
             max_abs_err=max_err,
             ms=served["ms"], plain_ms=served["plain_ms"],
             bound_ms=served["bound_ms"], bound_by=served["bound_by"],
             library_ms=served["library_ms"]),
        dict(name="flash_attention_fwd", route="cuda",
             source="mllm_sparse_retrieval_tpu_torch/csrc/flash_attn.cu",
             replaces="mllm_sparse_retrieval_tpu/models/layers.py:199",
             launches=text_flash + img_flash + hyb_flash + live_flash
             + off_flash + train_launches["fwd"] + fam_flash + chat_flash
             + chat_train["fwd"] + stats_flash,
             **flash,
             at_g7=dict(shape=f"B={FLASH_B} T={internvl_seq} Hq/Hkv="
                        f"{INTERNVL_HEADS[0]}/{INTERNVL_HEADS[1]}",
                        launches=chat_flash, **flash_g7)),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             source="mllm_sparse_retrieval_tpu_torch/csrc/flash_attn_bwd.cu",
             replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:941",
             launches=train_launches["dkv"] + chat_train["dkv"],
             **dkv_kernel,
             at_g7=dict(shape=f"B={TRAIN_B} T={internvl_seq} Hq/Hkv="
                        f"{INTERNVL_HEADS[0]}/{INTERNVL_HEADS[1]}",
                        launches=chat_train["dkv"], **dkv_g7)),
        dict(name="flash_attention_bwd_dq", route="cuda",
             source="mllm_sparse_retrieval_tpu_torch/csrc/flash_attn_bwd.cu",
             replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
             launches=train_launches["dq"] + chat_train["dq"], **dq_kernel,
             at_g7=dict(shape=f"B={TRAIN_B} T={internvl_seq} Hq/Hkv="
                        f"{INTERNVL_HEADS[0]}/{INTERNVL_HEADS[1]}",
                        launches=chat_train["dq"], **dq_g7)),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())

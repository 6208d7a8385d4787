#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``csrc/`` with one plain ``nvcc`` call,
holds it against its plain PyTorch version at the benchmark shape and at the
shape the served path gives it, and serves text queries end to end through
the port's ``RetrievalService``: the full-width, full-depth
LLaVA-NeXT-Llama3-8B text tower (bf16 weights drawn on the card from a
seed), device term selection, and an impact index of 25,010 synthetic docs
scored by the TAAT kernel. Every served result must equal the matmul
backend's on the same terms.

Each phase prints one progress line with the seconds since start. The last
lines are a JSON object describing the kernels, the card's name and power
limit as ``nvidia-smi`` reports them, and ``{"ok": true, "device": ...}``.
Without a CUDA card, or without the rest of the repository beside it, the
script fails before printing any result. It imports nothing of JAX.
"""

from __future__ import annotations

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

# benchmark shape (bench.py): Zipf terms, docs, queries of Q terms
BENCH_TERMS, N_DOCS, DOC_K, BENCH_B, BENCH_Q = 20_000, 25_010, 128, 256, 64
# served slice
VOCAB_WORDS = 20_000            # tokenizer vocabulary size
N_QUERIES, N_THREADS, MAX_BATCH, DEPTH = 32, 8, 8, 10
# a served batch takes tens of ms: these limits only make a hang fail fast
WARMUP_TIMEOUT_S, REQUEST_TIMEOUT_S, SERVE_DEADLINE_S = 60, 30, 60
STAGES = ("tower", "lm_head", "term_select")   # profiler ranges of encode


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


def check_kernel(label, matrix, safe_idx, safe_w, iters):
    """Kernel vs plain version (must be exactly equal), their times, the
    f32 query-table matmul's time and the bound."""
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
    progress("kernel", f"{label}: exact (max abs err {err}); kernel "
             f"{ms:.4f} ms, plain {plain_ms:.4f} ms, f32 query-table "
             f"matmul {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
             f"({bound_by})")
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
    factors = []
    for fn, dtype in ((SP._taat_topk, "i16"), (SP._impact_topk, "f32")):
        matrix = index._materialize(dtype)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(matrix, q_i, q_f, N_DOCS, 1000)
        torch.cuda.synchronize()
        factors.append((torch.cuda.max_memory_allocated() - base)
                       / (BENCH_B * matrix.shape[1] * 4))
    progress("kernel", f"search chunk peak memory / score tensor: taat "
             f"{factors[0]:.3f}, matmul {factors[1]:.3f} (depth 1000)")
    index.drop_device_cache()
    torch.cuda.empty_cache()
    return out


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


class RecordingEncoder:
    """Wraps an encoder and keeps the terms it selected for each text, so
    the served results can be checked against the matmul backend on
    exactly the terms that were served."""

    def __init__(self, encoder):
        self._enc = encoder
        self.terms = {}
        self.tower_s = []

    def __getattr__(self, name):
        return getattr(self._enc, name)

    def encode_texts(self, texts, pad_to=None):
        t0 = time.monotonic()
        dense, terms = self._enc.encode_texts(texts, pad_to)
        self.tower_s.append(time.monotonic() - t0)
        self.terms.update(zip(texts, terms))
        return dense, terms


def host_ms(fn, iters: int) -> float:
    """Mean host-clock time of ``fn`` (which ends in a device sync)."""
    fn()
    t0 = time.monotonic()
    for _ in range(iters):
        fn()
    return (time.monotonic() - t0) * 1e3 / iters


def profiled(fn):
    """One call of ``fn`` under ``torch.profiler``: (device ms of every
    kernel and copy it ran, kernel count, device ms under each of
    ``STAGES``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, n, stage = 0.0, 0, dict.fromkeys(STAGES, 0.0)
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and \
                not getattr(evt, "is_user_annotation", False):
            busy += evt.self_device_time_total / 1e3
            n += 1
        elif evt.device_type == DeviceType.CPU and evt.name in stage:
            stage[evt.name] += evt.device_time_total / 1e3
    return busy, n, stage


def breakdown(encoder, index, q_idx, q_w, batch):
    """Where one served micro-batch's time goes: the host clock of the
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
    e_busy, e_n, stage = profiled(encode)
    s_busy, s_n, _ = profiled(search)
    if e_busy <= 0.0 or s_busy <= 0.0:
        raise AssertionError("the profiler saw no device time")
    stages = ", ".join(f"{k} {v:.3f} ms" for k, v in stage.items())
    progress("breakdown", f"one {b}-query batch: encode_texts {encode_ms:.2f}"
             f" ms host clock, device {e_busy:.3f} ms in {e_n} kernels and "
             f"copies (busy share {e_busy / encode_ms:.3f}; {stages}); "
             f"search_encoded taat {search_ms:.3f} ms host clock, device "
             f"{s_busy:.4f} ms in {s_n} kernels and copies")


def same_up_to_ties(got, want):
    """Equal (doc, score) sets, except for docs tied at the depth cut."""
    g, w = set(got), set(want)
    if sorted(s for _, s in g) != sorted(s for _, s in w):
        return False
    if len(got) < DEPTH:
        return g == w
    cut = min(s for _, s in g)
    return {x for x in g if x[1] > cut} == {x for x in w if x[1] > cut}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2
    from mllm_sparse_retrieval_tpu_torch.configs import (
        ModelFamily, SparseConfig)
    from mllm_sparse_retrieval_tpu_torch.index import ImpactIndex
    from mllm_sparse_retrieval_tpu_torch.models import mllm, templates
    from mllm_sparse_retrieval_tpu_torch.models.llama import param_count
    from mllm_sparse_retrieval_tpu_torch.models.registry import (
        get_family_spec)
    from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
        WordPieceLiteTokenizer)
    from mllm_sparse_retrieval_tpu_torch.ops import cuda_build
    from mllm_sparse_retrieval_tpu_torch.ops import impact_kernel as K
    from mllm_sparse_retrieval_tpu_torch.ops.impact_kernel import (
        prepare_query_arrays)
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
    so, build_s, msgs = cuda_build.build(K.SOURCE, verbose=True)
    regs = [ln.strip() for ln in msgs.splitlines() if "registers" in ln]
    progress("build", f"nvcc {build_s:.2f}s -> {so.name}; "
             + ("; ".join(regs) if regs else "already built"))

    # ---- 2. kernel at the benchmark shape ---------------------------------
    rng = np.random.default_rng(SEED)
    bench = phase_kernel_bench(rng)

    # ---- 3. the served slice -------------------------------------------------
    lexicon = synthetic_lexicon(rng, VOCAB_WORDS)
    tok = WordPieceLiteTokenizer.from_corpus_captions(
        captions(rng, lexicon, 20_000, 8, 14), vocab_size=VOCAB_WORDS)
    vocab = tok.get_vocab()
    word_ids = np.array(sorted(i for p, i in vocab.items()
                               if p.startswith("▁") and len(p) > 2))
    progress("slice", f"tokenizer: {tok.vocab_size} pieces, "
             f"{word_ids.size} word pieces")

    spec = get_family_spec(ModelFamily.LLAVA_NEXT_LLAMA3)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = mllm.init_params(spec.arch, gen, DEVICE, torch.bfloat16)
    torch.cuda.synchronize()
    n_params = param_count(params)
    t = spec.arch.text
    progress("slice", f"LLaVA-NeXT-Llama3-8B text tower: {n_params:,} bf16 "
             f"weights drawn on the card ({t.num_layers} layers, hidden "
             f"{t.hidden_size}, {t.num_heads}/{t.num_kv_heads} heads, FFN "
             f"{t.intermediate_size}, vocab {t.vocab_size}); "
             f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")

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

    sparse_cfg = SparseConfig()
    # the synthetic tokenizer has no Llama-3 chat specials, so the prompt
    # uses the plain-text wrapper the tiny family uses
    encoder = RecordingEncoder(OnlineQueryEncoder(
        params, spec.arch, tok, templates.TINY, sparse_cfg, max_text_len=64,
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
        results, latency = [None] * N_QUERIES, [None] * N_QUERIES
        errors = []

        def client(rows):
            try:
                for i in rows:
                    t_req = time.monotonic()
                    results[i] = svc.search(text=texts[i],
                                            timeout=REQUEST_TIMEOUT_S)
                    latency[i] = time.monotonic() - t_req
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=client, daemon=True,
                                    args=(range(k, N_QUERIES, N_THREADS),))
                   for k in range(N_THREADS)]
        t_run = time.monotonic()
        deadline = t_run + SERVE_DEADLINE_S
        for th in threads:
            th.start()
        for th in threads:
            th.join(max(0.0, deadline - time.monotonic()))
        wall = time.monotonic() - t_run
        launches = K.launch_count()
        alive = sum(th.is_alive() for th in threads)
        if alive:
            answered = sum(r is not None for r in results)
            progress("slice", f"{alive} client threads still waiting after "
                     f"{SERVE_DEADLINE_S} s; {answered} of {N_QUERIES} "
                     f"queries answered")
            raise TimeoutError("the served path did not answer in time")
        if errors:
            raise errors[0]
        stats = svc.stats()
    finally:
        svc.close()

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lat_ms = np.array(latency) * 1e3
    progress("slice", f"served {N_QUERIES} text queries from {N_THREADS} "
             f"threads in {stats['batches'] - batches0} micro-batches; "
             f"TAAT launches {launches}; "
             f"p50 {np.percentile(lat_ms, 50):.2f} ms, p99 "
             f"{np.percentile(lat_ms, 99):.2f} ms, "
             f"{N_QUERIES / wall:.2f} QPS; tower+select "
             f"{np.mean(encoder.tower_s) * 1e3:.2f} ms per batch; peak "
             f"{peak_gb:.2f} GB; card {card}")
    if launches < 1:
        raise AssertionError("the served path never launched the TAAT kernel")

    # every query: >= 1 positive finite term, >= 1 hit, and the same
    # (doc, score) set as the matmul backend on the same terms
    served_terms = [encoder.terms[q] for q in texts]
    for q, st, row in zip(texts, served_terms, results):
        w = np.asarray(st.weights, np.float64)
        if not (w.size and np.isfinite(w).all() and (w > 0).any()):
            raise AssertionError(f"query {q!r} selected no usable term: {st}")
        if not row or not all(np.isfinite(s) and s > 0 for _, s in row):
            raise AssertionError(f"query {q!r} got no hit: {row}")
    ref_s, ref_i = index.search_terms(served_terms, DEPTH,
                                      canonical_map=cmap, backend="matmul")
    for q, row, s_row, i_row in zip(texts, results, ref_s, ref_i):
        if not same_up_to_ties(row, list(zip(i_row, s_row))):
            raise AssertionError(f"query {q!r}: taat {row} != matmul "
                                 f"{list(zip(i_row, s_row))}")
    progress("slice", f"all {N_QUERIES} results equal the matmul backend's")

    # ---- 4. the kernel at the served shape ----------------------------------
    q_idx, q_w = index.encode_query_terms(served_terms[:MAX_BATCH], cmap)
    safe_idx, safe_w = (torch.from_numpy(a).to(DEVICE)
                        for a in prepare_query_arrays(q_idx, q_w))
    matrix = index._materialize("i16")
    served = check_kernel(
        f"served shape {tuple(matrix.shape)} int16, B={q_idx.shape[0]} "
        f"Q={q_idx.shape[1]}", matrix, safe_idx, safe_w, iters=200)
    breakdown(encoder, index, q_idx, q_w, texts[:MAX_BATCH])

    max_err = max(bench["i16"]["max_abs_err"], bench["f32"]["max_abs_err"],
                  served["max_abs_err"])
    kernel = dict(
        name="taat_impact", route="cuda",
        source="mllm_sparse_retrieval_tpu_torch/csrc/taat.cu",
        replaces="mllm_sparse_retrieval_tpu/ops/impact_kernel.py:115",
        launches=launches, max_abs_err=max_err, ms=served["ms"],
        plain_ms=served["plain_ms"], bound_ms=served["bound_ms"],
        bound_by=served["bound_by"], library_ms=served["library_ms"])
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())

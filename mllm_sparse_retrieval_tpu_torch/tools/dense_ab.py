"""Interleaved A/B/C: f32 against bf16 against int8 dense MIPS (the dense
index's dtype modes).

Measures, in one process with alternating reps, at COCO scale (25,010 docs
x 4,096 d, the LLaVA hidden size; depth 10 as the reference's dense-only
search script):
  A) ``DenseFlatIndex(dtype=float32)``: full f32 scores (TF32 off),
     FAISS-flat parity;
  B) ``DenseFlatIndex(dtype=bfloat16)``: half the device bytes, one
     cuBLAS bf16 GEMM with f32 accumulation and f32 scores;
  C) ``DenseFlatIndex(dtype=int8)``: FAISS-SQ8-class scalar quantization,
     a quarter of the bytes, an exact int8 x int8 -> int32 product
     (``torch._int_mm``), per-row and per-query dequantization.

Reports, for each: the upload to device memory, device compute per batch
(queries already on the card; CUDA events around back-to-back calls), the
end-to-end ``batch_search`` per batch on the host clock (query upload and
the packed copy back included), and each mode's top-k overlap with f32 on
the same data.

    python -m mllm_sparse_retrieval_tpu_torch.tools.dense_ab \\
        [--docs 25010] [--dim 4096] [--reps 4] [--device cuda]

``main`` returns the printed numbers and, under ``topk``, each mode's
``(scores, row ids)`` of the first 256 queries.
"""

import argparse

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.tools.common import (
    checked_device, device_seconds, hardware, host_seconds, sync)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--docs", type=int, default=25_010)
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda needs a card")
    args = ap.parse_args(argv)
    device = checked_device(args.device)

    from mllm_sparse_retrieval_tpu_torch.index import DenseFlatIndex
    from mllm_sparse_retrieval_tpu_torch.ops.mips import (
        mips_topk, mips_topk_packed_q8)

    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(args.docs, args.dim)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = rng.normal(size=(args.batch, args.dim)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    ids = [str(i) for i in range(args.docs)]

    out = {"place_s": {}, "device_ms": {}, "e2e_ms": {}, "overlap": {},
           "top1": {}, "topk": {}}
    indexes = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16),
                        ("int8", torch.int8)):
        idx = DenseFlatIndex(dtype=dtype, device=device)
        idx.add(corpus, ids)
        _, place = host_seconds(idx._materialize, device)
        mb = _nbytes(idx._corpus_dev) / 1e6
        out["place_s"][name] = place
        print(f"[{name}] upload to device memory: {place:.1f} s "
              f"({mb:.0f} MB)", flush=True)
        indexes[name] = idx

    # Device-compute leg: queries already on the card in the index dtype.
    # int8 quantizes the queries and their scales beforehand and runs the
    # packed SQ8 program (its serving form); f32 and bf16 the top-k.
    def make_runner(idx):
        if idx.q8:
            q8, qs = idx._quantize_rows(queries)
            width = idx._corpus_dev.shape[1]
            if q8.shape[1] < width:
                q8 = np.pad(q8, ((0, 0), (0, width - q8.shape[1])))
            q8_dev = torch.from_numpy(np.ascontiguousarray(q8)).to(device)
            qs_dev = torch.from_numpy(qs).to(device)
            return lambda: mips_topk_packed_q8(
                q8_dev, qs_dev, idx._corpus_dev, idx._row_scale_dev,
                args.depth, idx._n_valid)
        q_dev = torch.from_numpy(queries).to(device).to(idx.dtype)
        return lambda: mips_topk(q_dev, idx._corpus_dev, args.depth)[0]

    runners = {name: make_runner(idx) for name, idx in indexes.items()}
    for run in runners.values():
        run()                                   # first use
    sync(device)

    # throughput: k back-to-back calls between two events; the card runs
    # them in order, so the span / k is the compute per batch
    flops = 2.0 * args.docs * args.batch * args.dim
    k_pipe = 8
    best = {}
    for _ in range(args.reps):
        for name, run in runners.items():
            t = device_seconds(run, device, k_pipe)
            best[name] = min(best.get(name, t), t)
    for name, t in best.items():
        out["device_ms"][name] = t * 1e3
        print(f"[{name}] device compute: {t * 1e3:.2f} ms/batch -> "
              f"{args.batch / t:.0f} QPS ({flops / t / 1e12:.1f} TFLOP/s)",
              flush=True)
    for name in ("bf16", "int8"):
        print(f"{name} device-compute speedup: "
              f"{best['f32'] / best[name]:.2f}x", flush=True)

    # end to end through DenseFlatIndex.batch_search (the query upload and
    # the packed copy back included)
    e2e = {}
    for idx in indexes.values():        # warm every program first
        idx.batch_search(queries, args.depth, batch_size=args.batch)
    for _ in range(args.reps):
        for name, idx in indexes.items():
            _, t = host_seconds(lambda: idx.batch_search(
                queries, args.depth, batch_size=args.batch), device)
            e2e[name] = min(e2e.get(name, t), t)
    for name, t in e2e.items():
        out["e2e_ms"][name] = t * 1e3
        print(f"[{name}] e2e batch_search: {t * 1e3:.1f} ms/batch -> "
              f"{args.batch / t:.0f} QPS", flush=True)
    for name in ("bf16", "int8"):
        print(f"{name} e2e speedup: {e2e['f32'] / e2e[name]:.2f}x",
              flush=True)

    # rank agreement on this data (Gaussian rows: the hard case for low
    # precision; caption embeddings separate further)
    s32, i32 = indexes["f32"].search(queries[:256], args.depth)
    out["topk"]["f32"] = (s32, i32)
    for name in ("bf16", "int8"):
        s_lo, i_lo = indexes[name].search(queries[:256], args.depth)
        out["topk"][name] = (s_lo, i_lo)
        overlap = float(np.mean([len(set(i32[r]) & set(i_lo[r])) / args.depth
                                 for r in range(i32.shape[0])]))
        top1 = float(np.mean(i32[:, 0] == i_lo[:, 0]))
        out["overlap"][name], out["top1"][name] = overlap, top1
        print(f"{name} vs f32 top-{args.depth} overlap: {overlap:.4f}; "
              f"top-1 agreement: {top1:.4f}", flush=True)
    print(f"hardware: {hardware(device)}", flush=True)
    return out


if __name__ == "__main__":
    main()

"""Serving tail-latency profile: per-batch latency percentiles, not QPS.

Throughput hides the serving property production cares about: the latency
distribution a closed-loop consumer sees per batch. This drives
``ImpactIndex.search_encoded_stream`` as a serving loop does (a new batch
is submitted as soon as the pipeline accepts it, results are consumed in
order) and records, per batch, the wall time from submit to results in
host memory. Reports p50/p90/p95/p99/max plus the steady-state gap
between results (effective ms per batch).

The first ``--warm`` batches are excluded (first use of the kernel and
the allocator). With ``--wire compact48`` the sparse fetch brings back 6
bytes a result instead of 8 (``ops/packing.py``): at depth 1,000 the copy
back is a large share of a batch.

    python -m mllm_sparse_retrieval_tpu_torch.tools.latency_profile \\
        [--docs 25010] [--batch 1024] [--depth 1000] [--rounds 24] \\
        [--wire i32|compact48] [--backend auto|taat|matmul] [--device cuda]

``main`` returns the printed numbers (ms) and the first measured batch's
``(scores, ids)`` under ``first``.
"""

import argparse
import time

import numpy as np

from mllm_sparse_retrieval_tpu_torch.tools.common import (
    checked_device, hardware, sync, zipf_docs, zipf_p, zipf_queries)

N_TERMS = 20_000
DOC_K = 128
QUERY_TERMS = 64


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--docs", type=int, default=25_010)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--depth", type=int, default=1000)
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--warm", type=int, default=4)
    ap.add_argument("--wire", default="i32", choices=["i32", "compact48"])
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "taat", "matmul"])
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda needs a card")
    args = ap.parse_args(argv)
    device = checked_device(args.device)

    from mllm_sparse_retrieval_tpu_torch.index import ImpactIndex

    rng = np.random.default_rng(0)
    zipf = zipf_p(N_TERMS)
    doc_t, doc_w = zipf_docs(rng, args.docs, N_TERMS, DOC_K, zipf)
    index = ImpactIndex.from_packed_arrays(doc_t, doc_w,
                                           term_keys=range(N_TERMS),
                                           device=device)
    q_i, q_w = zipf_queries(rng, args.batch, N_TERMS, QUERY_TERMS, zipf)
    q_i, q_w = q_i.astype(np.int32), q_w.astype(np.float32)
    index._materialize("i16" if args.backend != "matmul" else "f32")
    sync(device)

    total = args.warm + args.rounds
    submit_t = []

    def batches():
        for r in range(total):
            submit_t.append(time.perf_counter())
            yield (np.roll(q_i, r, axis=0), np.roll(q_w, r, axis=0))

    resolve_t, first = [], None
    t_start = time.perf_counter()
    for n, out in enumerate(index.search_encoded_stream(
            batches(), args.depth, backend=args.backend, wire=args.wire)):
        resolve_t.append(time.perf_counter())
        if n == args.warm:
            first = out
    t_end = time.perf_counter()

    lat = 1e3 * (np.asarray(resolve_t) - np.asarray(submit_t[:len(resolve_t)]))
    lat = lat[args.warm:]
    gaps = 1e3 * np.diff(np.asarray(resolve_t[args.warm:]))

    def q(p):
        return float(np.percentile(lat, p))

    print(f"latency profile: {args.docs} docs, batch {args.batch}, depth "
          f"{args.depth}, backend {args.backend}, wire {args.wire}, "
          f"{len(lat)} measured batches")
    print(f"  per-batch latency ms: p50 {q(50):.1f}  p90 {q(90):.1f}  "
          f"p95 {q(95):.1f}  p99 {q(99):.1f}  max {lat.max():.1f}")
    out = {"p50": q(50), "p90": q(90), "p95": q(95), "p99": q(99),
           "max": float(lat.max()), "first": first}
    if gaps.size:
        out["gap_mean"] = float(gaps.mean())
        out["gap_p99"] = float(np.percentile(gaps, 99))
        out["qps"] = args.batch / gaps.mean() * 1e3
        print(f"  steady-state gap: mean {gaps.mean():.1f} ms/batch "
              f"(p99 {np.percentile(gaps, 99):.1f}) -> "
              f"{args.batch / gaps.mean() * 1e3:.0f} QPS sustained")
    out["whole_s"] = t_end - t_start
    print(f"  whole run: {t_end - t_start:.2f}s for {total} batches "
          f"(incl. {args.warm} warmup); {hardware(device)}")
    return out


if __name__ == "__main__":
    main()

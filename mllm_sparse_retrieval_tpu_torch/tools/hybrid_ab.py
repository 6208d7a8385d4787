"""Interleaved A/B: host-fused hybrid search against the device-fused one.

The reference's hybrid pipeline runs at depth 1,000: a dense run and a
sparse run brought to the host, then min-max fusion in Python. That is two
``[B, 2 * depth]`` packed copies per batch plus ~2 * depth dict operations
per query of host fusion.

This tool measures, in one process with alternating reps (so drift hits
every leg):
  A) host path: ``DenseFlatIndex.search_ids`` + ``ImpactIndex.
     search_encoded`` -> ``make_run`` x 2 -> ``fuse`` (``fusion_mode=
     'host'``);
  B) device path: ``FusedHybridSearcher.search_encoded``, both engines'
     top-k fused on the card, one packed ``[B, 2 * out_depth]`` copy per
     chunk (``fusion_mode='device'``), at ``out_depth = depth`` (full
     depth) and at ``--out-depth`` (200: the recall consumer's largest
     k); and the same through ``search_encoded_stream``.
The sparse engine is the TAAT kernel on the card, the matmul backend on
the CPU.

    python -m mllm_sparse_retrieval_tpu_torch.tools.hybrid_ab \\
        [--docs 25010] [--dim 1024] [--batch 1024] [--depth 1000] \\
        [--reps 4] [--device cuda]

``main`` returns the best ms per batch of each leg and, under ``first``,
the first round's host-fused run (qid -> {doc: score}) and the device
path's ``(scores, ids)`` at full depth.
"""

import argparse

import numpy as np

from mllm_sparse_retrieval_tpu_torch.tools.common import (
    checked_device, hardware, host_seconds, interleaved, normal_rows,
    zipf_docs, zipf_p, zipf_queries)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--docs", type=int, default=25_010)
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--terms", type=int, default=20_000)
    ap.add_argument("--doc-k", type=int, default=128)
    ap.add_argument("--query-terms", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--depth", type=int, default=1000)
    ap.add_argument("--out-depth", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda needs a card")
    args = ap.parse_args(argv)
    device = checked_device(args.device)

    from mllm_sparse_retrieval_tpu_torch.index import (
        DenseFlatIndex, ImpactIndex)
    from mllm_sparse_retrieval_tpu_torch.search.device_fusion import (
        FusedHybridSearcher)
    from mllm_sparse_retrieval_tpu_torch.search.fusion import fuse
    from mllm_sparse_retrieval_tpu_torch.search.runs import make_run

    rng = np.random.default_rng(0)
    zipf = zipf_p(args.terms)
    doc_terms, doc_weights = zipf_docs(rng, args.docs, args.terms,
                                       args.doc_k, zipf)
    impact = ImpactIndex.from_packed_arrays(doc_terms, doc_weights,
                                            term_keys=range(args.terms),
                                            device=device)
    dense = DenseFlatIndex(device=device)
    dense.add(normal_rows(rng, args.docs, args.dim), impact.doc_ids)

    backend = "taat" if device.type == "cuda" else "matmul"

    def place():
        impact._materialize("i16" if backend == "taat" else "f32")
        dense._materialize()

    _, placed = host_seconds(place, device)
    print(f"upload to device memory: {placed:.1f}s", flush=True)

    q_idx, q_w = zipf_queries(rng, args.batch, args.terms, args.query_terms,
                              zipf)
    q_idx, q_w = q_idx.astype(np.int32), q_w.astype(np.float32)
    q_reps = normal_rows(rng, args.batch, args.dim)
    batches = []
    for r in range(args.rounds):
        batches.append((np.roll(q_reps, r, axis=0),
                        np.roll(q_idx, r, axis=0), np.roll(q_w, r, axis=0)))
    qids = [str(-1 - i) for i in range(args.batch)]  # no self hits
    fused = FusedHybridSearcher(dense, impact, alpha=args.alpha,
                                backend=backend)
    first = {}

    def run_host():
        for n, (reps_b, qi, qw) in enumerate(batches):
            d_s, d_i = dense.search_ids(reps_b, args.depth,
                                        batch_size=args.batch)
            d_run = make_run(qids, d_s.tolist(), d_i, scores_sorted=True)
            s_s, s_i = impact.search_encoded(qi, qw, args.depth,
                                             backend=backend)
            s_run = make_run(qids, s_s, s_i, scores_sorted=True)
            out = fuse([d_run, s_run], [args.alpha, 1.0 - args.alpha])
            if n == 0:
                first["host"] = out

    def run_device(out_depth):
        for n, (reps_b, qi, qw) in enumerate(batches):
            out = fused.search_encoded(reps_b, qi, qw, args.depth,
                                       out_depth=out_depth)
            if n == 0 and out_depth == args.depth:
                first["device"] = out

    def run_stream(out_depth):
        for _ in fused.search_encoded_stream(batches, args.depth,
                                             out_depth=out_depth):
            pass

    legs = [("host ", run_host),
            (f"dev{args.depth:>4}", lambda: run_device(args.depth)),
            (f"dev{args.out_depth:>4}", lambda: run_device(args.out_depth)),
            (f"str{args.depth:>4}", lambda: run_stream(args.depth)),
            (f"str{args.out_depth:>4}", lambda: run_stream(args.out_depth))]
    for _, f in legs:
        f()  # warm
    times = interleaved(legs, args.reps, device, per=args.rounds)
    print(f"config: {args.docs} docs, dim {args.dim}, batch {args.batch}, "
          f"depth {args.depth}, backend {backend}; {hardware(device)}")
    base, out = None, {"first": first, "qids": qids}
    for name, _ in legs:
        ts = times[name]
        best = min(ts)
        if base is None:
            base = best
        out[name.strip() + "_ms"] = best * 1e3
        print(f"{name}: best {best * 1e3:7.1f} ms/batch "
              f"({args.batch / best:7.0f} QPS)  x{base / best:.2f} vs host  "
              f"all [{', '.join(f'{t * 1e3:.0f}' for t in ts)}]")
    return out


if __name__ == "__main__":
    main()

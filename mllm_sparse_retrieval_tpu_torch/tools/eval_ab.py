"""Interleaved A/B: the host evaluation consumer against the device one.

The reference's retrieval pipeline ends in recall metrics at depth 1,000.
The host consumer copies the ``[B, 2 * depth]`` packed run back, builds run
dicts and partial-sorts per query; the device consumer
(``ops/eval_ranks.py`` + ``eval/device_eval.py``) computes the targets'
ranks on the card and copies one ``[B, 1 + T]`` int32 array back, with
equal metric values.

Measures, in one process with alternating reps (so drift hits every leg),
each leg timed through its recall@{1,5,10,100,200}:

  sparse/host  — search_encoded -> make_run -> recall_at_k
  sparse/dev   — impact_eval_ranks -> metrics_from_ranks
  hybrid/host  — dense + sparse runs + fuse -> recall_at_k
                 (the reference's configuration, fusion_mode='host')
  hybrid/fused — FusedHybridSearcher.search_run -> recall_at_k
                 (fusion_mode='device', host eval)
  hybrid/dev   — FusedHybridSearcher.eval_ranks -> metrics_from_ranks
                 (fusion_mode='device', eval_mode='device')

Every leg's recall must equal the host consumer's before timing; a
mismatch exits 1.

    python -m mllm_sparse_retrieval_tpu_torch.tools.eval_ab \\
        [--docs 25010] [--batch 1024] [--depth 1000] [--device cuda]

``main`` returns the exit code's check under ``parity`` (True when every
leg matched), each leg's recall under ``recall`` and best ms per batch
under ``ms``.
"""

import argparse
import sys

import numpy as np

from mllm_sparse_retrieval_tpu_torch.tools.common import (
    checked_device, hardware, host_seconds, interleaved, normal_rows,
    zipf_docs, zipf_p, zipf_queries)

KS = (1, 5, 10, 100, 200)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--docs", type=int, default=25_010)
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--terms", type=int, default=20_000)
    ap.add_argument("--doc-k", type=int, default=128)
    ap.add_argument("--query-terms", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--depth", type=int, default=1000)
    ap.add_argument("--targets", type=int, default=5,
                    help="relevant docs per query (image queries have ~5)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--sparse-only", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda needs a card")
    args = ap.parse_args(argv)
    device = checked_device(args.device)

    from mllm_sparse_retrieval_tpu_torch.eval.device_eval import (
        build_target_arrays, dense_doc_pos, impact_doc_pos,
        impact_eval_ranks, metrics_from_ranks)
    from mllm_sparse_retrieval_tpu_torch.eval.recall import recall_at_k
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
    doc_ids = list(impact.doc_ids)
    dense = None
    if not args.sparse_only:
        dense = DenseFlatIndex(device=device)
        dense.add(normal_rows(rng, args.docs, args.dim), doc_ids)

    backend = "taat" if device.type == "cuda" else "matmul"

    def place():
        impact._materialize("i16" if backend == "taat" else "f32")
        if dense is not None:
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
    qids = [f"q{i}" for i in range(args.batch)]
    tmap = {q: [doc_ids[int(j)] for j in
                rng.choice(args.docs, size=args.targets, replace=False)]
            for q in qids}
    get_target = tmap.__getitem__

    tgt_i, ntg, selfp = build_target_arrays(qids, get_target,
                                            impact_doc_pos(impact))
    fused = tgt_d = None
    if dense is not None:
        fused = FusedHybridSearcher(dense, impact, alpha=args.alpha,
                                    backend=backend)
        tgt_d, _, _ = build_target_arrays(qids, get_target,
                                          dense_doc_pos(dense))

    def sparse_host():
        out = None
        for _, qi, qw in batches:
            s, i = impact.search_encoded(qi, qw, args.depth, backend=backend)
            run = make_run(qids, s, i, scores_sorted=True)
            out = recall_at_k(run, get_target, KS)
        return out

    def sparse_dev():
        out = None
        for _, qi, qw in batches:
            ranks = impact_eval_ranks(impact, qi, qw, tgt_i, selfp,
                                      args.depth, backend=backend)
            out, _ = metrics_from_ranks(qids, ranks, ntg, KS)
        return out

    def hybrid_host():
        out = None
        for reps_b, qi, qw in batches:
            d_s, d_i = dense.search_ids(reps_b, args.depth,
                                        batch_size=args.batch)
            d_run = make_run(qids, d_s.tolist(), d_i, scores_sorted=True)
            s_s, s_i = impact.search_encoded(qi, qw, args.depth,
                                             backend=backend)
            s_run = make_run(qids, s_s, s_i, scores_sorted=True)
            f = fuse([d_run, s_run], [args.alpha, 1.0 - args.alpha])
            out = recall_at_k(f, get_target, KS)
        return out

    def hybrid_fused_host_eval():
        out = None
        for reps_b, qi, qw in batches:
            run = fused.search_run(reps_b, qi, qw, qids, args.depth)
            out = recall_at_k(run, get_target, KS)
        return out

    def hybrid_dev():
        out = None
        for reps_b, qi, qw in batches:
            ranks = fused.eval_ranks(reps_b, qi, qw, tgt_d, args.depth)
            out, _ = metrics_from_ranks(qids, ranks, ntg, KS)
        return out

    legs = [("sparse/host ", sparse_host, "sparse"),
            ("sparse/dev  ", sparse_dev, "sparse")]
    if dense is not None:
        legs += [("hybrid/host ", hybrid_host, "hybrid"),
                 ("hybrid/fused", hybrid_fused_host_eval, "fused"),
                 ("hybrid/dev  ", hybrid_dev, "fused")]

    # warm + parity check: the device legs must report the host leg's
    # recall
    warm = {name: (f(), family) for name, f, family in legs}
    result = {"recall": {name.strip(): r.recalls
                         for name, (r, _) in warm.items()}, "parity": True}
    for fam in ("sparse", "fused"):
        vals = [r.recalls for (r, f) in warm.values() if f == fam]
        for v in vals[1:]:
            if v != vals[0]:
                print(f"FAIL: {fam} recall mismatch: {v} != {vals[0]}",
                      flush=True)
                result["parity"] = False
    if not result["parity"]:
        return result
    print("parity: device-consumer recall == host-consumer recall "
          f"(sparse r@10={warm['sparse/host '][0][10]:.4f})", flush=True)

    times = interleaved([(name, f) for name, f, _ in legs], args.reps,
                        device, per=args.rounds)
    print(f"config: {args.docs} docs, batch {args.batch}, depth "
          f"{args.depth}, {args.targets} targets/query, backend {backend}; "
          f"{hardware(device)}")
    base, result["ms"] = {}, {}
    for name, _, family in legs:
        ts = times[name]
        best = min(ts)
        key = "sparse" if family == "sparse" else "hybrid"
        base.setdefault(key, best)
        result["ms"][name.strip()] = best * 1e3
        print(f"{name}: best {best * 1e3:7.1f} ms/batch "
              f"({args.batch / best:7.0f} QPS)  x{base[key] / best:.2f} "
              f"vs {key}/host  "
              f"all [{', '.join(f'{t * 1e3:.0f}' for t in ts)}]")
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["parity"] else 1)

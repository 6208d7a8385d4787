"""Interleaved A/B: the raw array search path against the id-keyed engine
path.

Measures, in one process with alternating reps (so drift hits every leg):
  A) ``ImpactIndex.search_encoded_stream`` on pre-encoded padded arrays;
  B) ``SelectedTerms`` -> ``search_terms_stream`` -> ``search.runs.make_run``
     (the ``run_search`` product path);
  C) the same stream into ``ArrayRun`` (run construction deferred to the
     consumers that need dicts).
Every leg runs on the TAAT kernel; each leg's window ends with its
results in host memory.

    python -m mllm_sparse_retrieval_tpu_torch.tools.engine_ab \\
        [--docs 25010] [--batch 4096] [--reps 4] [--device cuda]

``main`` returns the best ms per batch of each leg and the first round's
``(scores, ids)`` of the array and engine paths under ``first``.
"""

import argparse
import time

import numpy as np

from mllm_sparse_retrieval_tpu_torch.tools.common import (
    checked_device, hardware, interleaved, sync, zipf_docs, zipf_p,
    zipf_queries)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--docs", type=int, default=25_010)
    ap.add_argument("--terms", type=int, default=20_000)
    ap.add_argument("--doc-k", type=int, default=128)
    ap.add_argument("--query-terms", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda needs a card")
    args = ap.parse_args(argv)
    device = checked_device(args.device)

    from mllm_sparse_retrieval_tpu_torch.index import ImpactIndex
    from mllm_sparse_retrieval_tpu_torch.search.runs import (
        ArrayRun, make_run)
    from mllm_sparse_retrieval_tpu_torch.sparse import SelectedTerms

    rng = np.random.default_rng(0)
    zipf = zipf_p(args.terms)
    doc_terms, doc_weights = zipf_docs(rng, args.docs, args.terms,
                                       args.doc_k, zipf)
    index = ImpactIndex.from_packed_arrays(doc_terms, doc_weights,
                                           term_keys=range(args.terms),
                                           device=device)
    t0 = time.time()
    index._materialize("i16")
    sync(device)
    print(f"upload to device memory: {time.time() - t0:.1f}s", flush=True)

    q_idx, q_w = zipf_queries(rng, args.batch, args.terms, args.query_terms,
                              zipf)
    q_idx, q_w = q_idx.astype(np.int32), q_w.astype(np.float32)
    batches, term_batches = [], []
    for r in range(args.rounds):
        ri, rw = np.roll(q_idx, r, axis=0), np.roll(q_w, r, axis=0)
        batches.append((ri, rw))
        rwi = rw.astype(np.int32)
        term_batches.append(
            [SelectedTerms(ri[i], rwi[i]) for i in range(args.batch)])
    qids = [str(i) for i in range(args.batch)]
    first = {}

    def run_arrays():
        for n, out in enumerate(index.search_encoded_stream(
                batches, args.depth, backend="taat")):
            if n == 0:
                first["arrays"] = out

    def run_engine():
        for n, (s, i) in enumerate(index.search_terms_stream(
                term_batches, args.depth, backend="taat")):
            make_run(qids, s, i)
            if n == 0:
                first["engine"] = (s, i)

    def run_engine_lazy():
        # the same engine stream into ArrayRun: run construction is O(1),
        # dict assembly deferred to the consumers that read rows
        for s, i in index.search_terms_stream(term_batches, args.depth,
                                              backend="taat"):
            ArrayRun(qids, s, i, scores_sorted=True)

    legs = [("arrays", run_arrays), ("engine", run_engine),
            ("lazy  ", run_engine_lazy)]
    for _, f in legs:
        f()   # warm
    times = interleaved(legs, args.reps, device, per=args.rounds)
    best = {name: min(ts) for name, ts in times.items()}
    for name, _ in legs:
        print(f"{name} ms/batch:", [f"{x * 1e3:.1f}" for x in times[name]])
    a = best["arrays"]
    print(f"best: arrays {a * 1e3:.1f} ms ({args.batch / a:.0f} QPS)  "
          f"engine {best['engine'] * 1e3:.1f} ms "
          f"({args.batch / best['engine']:.0f} QPS, "
          f"gap {100 * (best['engine'] / a - 1):.1f}%)  "
          f"lazy {best['lazy  '] * 1e3:.1f} ms "
          f"({args.batch / best['lazy  ']:.0f} QPS, "
          f"gap {100 * (best['lazy  '] / a - 1):.1f}%); {hardware(device)}")
    return {"arrays_ms": a * 1e3, "engine_ms": best["engine"] * 1e3,
            "lazy_ms": best["lazy  "] * 1e3, "first": first}


if __name__ == "__main__":
    main()

"""Interleaved A/B: static against live index serving overhead (sparse and
dense).

The live layer (``index/live.py``) adds per-search costs over a static
index: a snapshot read, per-segment searches (base + deltas), over-fetch
for tombstones and the host top-k merge (``hostops.merge_topk_rows``).
The arena (``index/arena.py``) writes adds and deletes into one
capacity-reserved device matrix instead, filtered by a live mask. This
measures both at the headline shape, in one process:

  A) static ``ImpactIndex.search_encoded``
  B) ``LiveImpactIndex``, base only             (pure wrapper overhead)
  C) ``LiveImpactIndex``, base + 4 deltas + tombstones (steady state)
  and ``ArenaImpactIndex`` base-only and after the same adds and deletes
  (it wraps its own copy of the corpus, so its capacity placement never
  touches the static and segment legs); then the same for
  ``DenseFlatIndex`` / ``LiveDenseIndex`` / ``ArenaDenseIndex``.
Each leg is the best of ``--reps`` host-clock calls ending with results in
host memory.

    python -m mllm_sparse_retrieval_tpu_torch.tools.live_ab \\
        [--docs 25010] [--terms 20000] [--reps 4] [--device cuda]
    python -m mllm_sparse_retrieval_tpu_torch.tools.live_ab --smoke \\
        --device cpu

``main`` returns the best seconds of each leg under ``rows`` and the
results of the first call of the base-only legs under ``first``: the
static, segment and arena ``(scores, ids)`` of the sparse and the dense
engine.
"""

import argparse

import numpy as np

from mllm_sparse_retrieval_tpu_torch.tools.common import (
    checked_device, hardware, host_seconds, zipf_docs, zipf_p, zipf_queries)


def _best(fn, reps, device):
    return min(host_seconds(fn, device)[1] for _ in range(reps))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--docs", type=int, default=25_010)
    ap.add_argument("--terms", type=int, default=20_000)
    ap.add_argument("--doc-k", type=int, default=128)
    ap.add_argument("--q-k", type=int, default=64)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--delta-docs", type=int, default=512,
                    help="docs per delta segment (x4 deltas)")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda needs a card")
    args = ap.parse_args(argv)
    if args.smoke:
        args.docs, args.terms, args.doc_k, args.q_k = 2000, 400, 16, 8
        args.dim, args.batch, args.delta_docs, args.reps = 32, 256, 64, 2
    device = checked_device(args.device)

    from mllm_sparse_retrieval_tpu_torch.index import (
        ArenaDenseIndex, ArenaImpactIndex, DenseFlatIndex, ImpactIndex,
        LiveDenseIndex, LiveImpactIndex)

    rng = np.random.default_rng(0)
    zipf = zipf_p(args.terms)
    doc_t, doc_w = zipf_docs(rng, args.docs, args.terms, args.doc_k, zipf)
    impact = ImpactIndex.from_packed_arrays(doc_t, doc_w,
                                            term_keys=range(args.terms),
                                            device=device)
    q_idx, q_w = zipf_queries(rng, args.batch, args.terms, args.q_k, zipf)
    terms = [dict(zip(r.tolist(), w.tolist())) for r, w in zip(q_idx, q_w)]
    enc = impact.encode_queries(terms)
    first = {}

    def keep(name, out):
        first.setdefault(name, out)

    def sparse_static():
        keep("sparse_static",
             impact.search_encoded(*enc, args.depth, backend=args.backend))

    live_s = LiveImpactIndex(impact)

    def sparse_live():
        keep("sparse_live_base",
             live_s.search_rows(terms, args.depth, backend=args.backend))

    # the arena wraps its own copy (adoption drops device caches and
    # re-places with capacity: it must not touch the static leg's index)
    impact_b = ImpactIndex.from_packed_arrays(doc_t.copy(), doc_w.copy(),
                                              term_keys=range(args.terms),
                                              device=device)
    arena_s = ArenaImpactIndex(impact_b,
                               doc_headroom=4 * args.delta_docs + 1024)

    def sparse_arena():
        keep("sparse_arena_base",
             arena_s.search_rows(terms, args.depth, backend=args.backend))

    # warm, then measure
    sparse_static(), sparse_live(), sparse_arena()
    rows = {}
    for name, fn in (("sparse_static", sparse_static),
                     ("sparse_live_base", sparse_live),
                     ("sparse_arena_base", sparse_arena)):
        rows[name] = _best(fn, args.reps, device)

    # steady-state live: 4 deltas + tombstones in base and deltas
    for d in range(4):
        ids = [f"n{d}_{i}" for i in range(args.delta_docs)]
        docs = [(i, {int(t): int(rng.integers(1, 300))
                     for t in rng.choice(args.terms, 8, replace=False)})
                for i in ids]
        live_s.add_documents(docs)
        arena_s.add_documents(docs)
    dead = [impact.doc_ids[i] for i in range(0, 200, 2)] \
        + [f"n0_{i}" for i in range(0, 50)]
    live_s.delete_documents(dead)
    arena_s.delete_documents(dead)
    sparse_live(), sparse_arena()
    rows["sparse_live_deltas"] = _best(sparse_live, args.reps, device)
    rows["sparse_arena_mutated"] = _best(sparse_arena, args.reps, device)

    # the dense trio
    reps = rng.normal(size=(args.docs, args.dim)).astype(np.float32)
    reps /= np.linalg.norm(reps, axis=1, keepdims=True)
    dense = DenseFlatIndex(device=device)
    dense.add(reps, [str(i) for i in range(args.docs)])
    q = rng.normal(size=(args.batch, args.dim)).astype(np.float32)

    def dense_static():
        keep("dense_static",
             dense.search_ids(q, args.depth, batch_size=args.batch))

    live_d = LiveDenseIndex(dense)

    def dense_live():
        keep("dense_live_base",
             live_d.search_rows(q, args.depth, batch_size=args.batch))

    dense_b = DenseFlatIndex(device=device)
    dense_b.add(reps, [str(i) for i in range(args.docs)])
    arena_d = ArenaDenseIndex(dense_b,
                              doc_headroom=4 * args.delta_docs + 1024)

    def dense_arena():
        keep("dense_arena_base",
             arena_d.search_rows(q, args.depth, batch_size=args.batch))

    dense_static(), dense_live(), dense_arena()
    for name, fn in (("dense_static", dense_static),
                     ("dense_live_base", dense_live),
                     ("dense_arena_base", dense_arena)):
        rows[name] = _best(fn, args.reps, device)
    for d in range(4):
        block = rng.normal(size=(args.delta_docs, args.dim)
                           ).astype(np.float32)
        ids = [f"m{d}_{i}" for i in range(args.delta_docs)]
        live_d.add_documents(block, ids)
        arena_d.add_documents(block, ids)
    dead_d = [str(i) for i in range(0, 200, 2)]
    live_d.delete_documents(dead_d)
    arena_d.delete_documents(dead_d)
    dense_live(), dense_arena()
    rows["dense_live_deltas"] = _best(dense_live, args.reps, device)
    rows["dense_arena_mutated"] = _best(dense_arena, args.reps, device)

    for name, t in rows.items():
        print(f"[{name}] {t * 1e3:.1f} ms/batch -> "
              f"{args.batch / t:.0f} QPS", flush=True)
    for eng in ("sparse", "dense"):
        base = rows[f"{eng}_static"]
        print(f"{eng} live overhead vs static: segments base-only "
              f"{rows[f'{eng}_live_base'] / base - 1:+.1%}, "
              f"segments 4 deltas+tombstones "
              f"{rows[f'{eng}_live_deltas'] / base - 1:+.1%}; "
              f"ARENA base-only "
              f"{rows[f'{eng}_arena_base'] / base - 1:+.1%}, "
              f"ARENA mutated "
              f"{rows[f'{eng}_arena_mutated'] / base - 1:+.1%}", flush=True)
    print(f"hardware: {hardware(device)}", flush=True)
    return {"rows": rows, "first": first}


if __name__ == "__main__":
    main()

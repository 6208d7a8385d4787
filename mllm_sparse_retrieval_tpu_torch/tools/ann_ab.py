"""Interleaved A/B: exact flat MIPS against ANN (low-rank prefilter +
exact rescore).

Measures, in one process with alternating reps:
  A) ``DenseFlatIndex(float32)``: the exact FAISS-flat-parity path;
  B) ``DenseFlatIndex(bfloat16)``: the exact bf16 tensor-core path;
  C) ``DenseANNIndex(rank, candidates)``: stage 1 ``[B, d] x [d, r]``
     queries against the ``[N, r]`` projected corpus, the top candidates,
     then the exact rescore of the candidate pool (``ops/ann.py``).

Reports device compute per batch (CUDA events around back-to-back calls),
QPS, the ANN speedup against each exact mode, and candidate recall@depth
against the f32 oracle on the same corpus. Corpus rows follow a
spectrally decaying model (embedding-like; an isotropic corpus is the
prefilter's worst case, ``--isotropic``).

    python -m mllm_sparse_retrieval_tpu_torch.tools.ann_ab \\
        [--docs 200000] [--dim 512] [--rank 64] [--candidates 1024] \\
        [--depth 10] [--reps 4] [--device cuda]

``main`` returns the printed numbers (device ms, candidate recall) and the
recall's id rows under ``ids`` (``exact`` and ``ann``).
"""

import argparse

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.tools.common import (
    checked_device, device_seconds, hardware, host_seconds, sync)


def _spectral_corpus(rng, n, d, isotropic=False):
    x = rng.normal(size=(n, d)).astype(np.float32)
    if not isotropic:
        # power-law singular-value decay, the shape of real embedding
        # matrices (most variance in the leading directions)
        x *= (np.arange(1, d + 1, dtype=np.float32) ** -0.75)[None, :]
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--docs", type=int, default=200_000)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--candidates", type=int, default=1024)
    ap.add_argument("--recall-target", type=float, default=0.95)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--isotropic", action="store_true",
                    help="flat-spectrum corpus (ANN worst case)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda needs a card")
    args = ap.parse_args(argv)
    device = checked_device(args.device)

    from mllm_sparse_retrieval_tpu_torch.index import (
        DenseANNIndex, DenseFlatIndex)
    from mllm_sparse_retrieval_tpu_torch.ops.ann import ann_topk_packed
    from mllm_sparse_retrieval_tpu_torch.ops.mips import mips_topk_packed

    rng = np.random.default_rng(0)
    corpus = _spectral_corpus(rng, args.docs, args.dim, args.isotropic)
    queries = _spectral_corpus(rng, args.batch, args.dim, args.isotropic)
    ids = [str(i) for i in range(args.docs)]

    modes = {
        "f32": DenseFlatIndex(dtype=torch.float32, device=device),
        "bf16": DenseFlatIndex(dtype=torch.bfloat16, device=device),
        "ann": DenseANNIndex(rank=args.rank, candidates=args.candidates,
                             recall_target=args.recall_target,
                             device=device),
    }
    out = {"device_ms": {}}
    for name, idx in modes.items():
        idx.add(corpus, ids)
        _, place = host_seconds(idx._materialize, device)
        extra = ""
        if name == "ann":
            extra = (f" (+{_nbytes(idx._corpus_r_dev) / 1e6:.0f} MB "
                     f"projected, rank {args.rank})")
        print(f"[{name}] upload to device memory: {place:.1f} s "
              f"({_nbytes(idx._corpus_dev) / 1e6:.0f} MB){extra}",
              flush=True)

    # device-compute leg: queries already on the card, k back-to-back
    # calls between two events
    staged = {name: torch.from_numpy(queries).to(device).to(idx.dtype)
              for name, idx in modes.items()}
    ann = modes["ann"]
    runners = {
        "f32": lambda: mips_topk_packed(
            staged["f32"], modes["f32"]._corpus_dev, args.depth),
        "bf16": lambda: mips_topk_packed(
            staged["bf16"], modes["bf16"]._corpus_dev, args.depth),
        "ann": lambda: ann_topk_packed(
            staged["ann"], ann._corpus_dev, ann._corpus_r_dev,
            ann._proj_dev, args.depth, max(args.candidates, args.depth),
            args.recall_target),
    }
    for run in runners.values():
        run()                                  # first use
    sync(device)

    k_pipe = 8
    best = {}
    for _ in range(args.reps):
        for name, run in runners.items():
            t = device_seconds(run, device, k_pipe)
            best[name] = min(best.get(name, t), t)
    exact_flops = 2.0 * args.docs * args.batch * args.dim
    for name, t in best.items():
        out["device_ms"][name] = t * 1e3
        note = f" ({exact_flops / t / 1e12:.1f} TFLOP/s)" \
            if name != "ann" else ""
        print(f"[{name}] device compute: {t * 1e3:.2f} ms/batch -> "
              f"{args.batch / t:.0f} QPS{note}", flush=True)
    for name in ("f32", "bf16"):
        print(f"ann speedup vs {name}: {best[name] / best['ann']:.2f}x",
              flush=True)

    # candidate recall against the f32 oracle (sampled queries)
    n_eval = min(512, args.batch)
    _, exact_ids = modes["f32"].search_ids(queries[:n_eval], args.depth,
                                           batch_size=n_eval)
    _, ann_ids = modes["ann"].search_ids(queries[:n_eval], args.depth,
                                         batch_size=n_eval)
    hits = sum(len(set(a) & set(e)) for a, e in zip(ann_ids, exact_ids))
    rec = hits / (args.depth * n_eval)
    print(f"ann candidate recall@{args.depth} vs exact: {rec:.4f} "
          f"(rank {args.rank}, candidates {args.candidates}, "
          f"recall_target {args.recall_target}); {hardware(device)}",
          flush=True)
    out.update(recall=rec, ids={"exact": exact_ids, "ann": ann_ids})
    return out


if __name__ == "__main__":
    main()

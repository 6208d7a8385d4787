"""Tensor-core probe of the dense MIPS program (``ops/mips.py``: scores
``q @ C.T``, then ``torch.topk``).

Decomposes the serving program on the card, per corpus dtype (f32 with
TF32 off, bf16 with f32 accumulation and output, int8 with an exact int32
product dequantized by the scale outer product), into three legs:

  matmul, then sum (unfused) — the product followed by a reduction over
                 the scores. PyTorch runs the two as separate kernels, so
                 the ``[B, N]`` f32 scores are written and read back:
                 this leg is no fused floor (an XLA program fuses the
                 reduction into the matmul epilogue; here nothing does);
  matmul-out   — the product returning the full ``[B, N]`` f32 scores;
  full (topk)  — the serving program: the product, then ``torch.topk``
                 reading the scores back.

Each leg is timed on the card with CUDA events around back-to-back calls
(the best of ``--reps`` samples). It prints TFLOP/s and the share of the
card's peak for the dtype (H100 SXM datasheet dense rates: f32 67e12,
bf16 989e12, int8 1979e12 operations/s). At 200,000 docs x 512 d and batch
4,096 the scores are 3.28 GB; one write and one read at 3.35e12 B/s take
~2 ms beside the bf16 product's ~0.85 ms at peak.

    python -m mllm_sparse_retrieval_tpu_torch.tools.mxu_probe \\
        [--docs 200000] [--dim 512] [--batch 4096] [--device cuda]

``main`` returns each dtype's three times (ms) and the f32 full leg's
``(scores, row ids)`` under ``full_topk``.
"""

import argparse
import sys

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.tools.common import (
    BF16_OPS_PER_S, F32_OPS_PER_S, INT8_OPS_PER_S, checked_device,
    device_seconds, hardware, sync)

PEAK = {"f32": F32_OPS_PER_S, "bf16": BF16_OPS_PER_S, "int8": INT8_OPS_PER_S}
LIVE_OUTPUT_BYTES = 8e9        # outputs a sample may hold at once


def _time(fn, device, reps=8, pipeline=8):
    """Best seconds per call over ``reps`` samples of ``pipeline``
    back-to-back calls between two events; the pipeline is cut so that
    the outputs it holds fit in ``LIVE_OUTPUT_BYTES`` (the matmul-out
    leg's ``[B, N]`` f32 is 3.3 GB at the default shape)."""
    warm = fn()
    leaves = warm if isinstance(warm, tuple) else (warm,)
    out_bytes = sum(t.numel() * t.element_size() for t in leaves)
    pipeline = max(1, min(pipeline, int(LIVE_OUTPUT_BYTES
                                        // max(out_bytes, 1))))
    del warm, leaves
    sync(device)
    held = []

    def call():
        held.append(fn())

    best = float("inf")
    for _ in range(reps):
        best = min(best, device_seconds(call, device, pipeline))
        held.clear()
    return best


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--docs", type=int, default=200_000)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda needs a card")
    args = ap.parse_args(argv)
    device = checked_device(args.device)

    from mllm_sparse_retrieval_tpu_torch.index import DenseFlatIndex
    from mllm_sparse_retrieval_tpu_torch.ops.mips import (
        _q8_scores, mips_scores)

    n, d, b, k = args.docs, args.dim, args.batch, args.depth
    flops = 2.0 * b * d * n
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)

    print(f"shape: {n} docs x {d} d, batch {b}, depth {k}; "
          f"{flops / 1e12:.2f} TFLOP/batch; {hardware(device)}",
          file=sys.stderr)

    result = {}
    for name in ("f32", "bf16", "int8"):
        if name == "int8":
            cq, cs = DenseFlatIndex._quantize_rows(corpus)
            qq, qs = DenseFlatIndex._quantize_rows(q)
            c8, q8 = (torch.from_numpy(a).to(device) for a in (cq, qq))
            cs_d, qs_d = (torch.from_numpy(a).to(device) for a in (cs, qs))

            def scores():
                return _q8_scores(q8, qs_d, c8, cs_d)
        else:
            dtype = torch.float32 if name == "f32" else torch.bfloat16
            c_dev = torch.from_numpy(corpus).to(device).to(dtype)
            q_dev = torch.from_numpy(q).to(device).to(dtype)

            def scores(q_dev=q_dev, c_dev=c_dev):
                return mips_scores(q_dev, c_dev)

        ts = _time(lambda: scores().sum(), device, reps=args.reps)
        to = _time(scores, device, reps=args.reps)
        tf = _time(lambda: torch.topk(scores(), min(k, n), dim=1), device,
                   reps=args.reps)
        if name == "f32":
            s, i = torch.topk(scores(), min(k, n), dim=1)
            result["full_topk"] = (s.cpu().numpy(), i.cpu().numpy())
        result[name] = {"sum_ms": ts * 1e3, "out_ms": to * 1e3,
                        "full_ms": tf * 1e3,
                        "peak_share": flops / tf / PEAK[name]}
        print(f"{name}: matmul then sum (unfused) {ts * 1e3:7.2f} ms "
              f"({flops / ts / 1e12:6.1f} TFLOP/s) | "
              f"matmul-out {to * 1e3:7.2f} ms "
              f"({flops / to / 1e12:6.1f}) | "
              f"full(topk) {tf * 1e3:7.2f} ms "
              f"({flops / tf / 1e12:6.1f}; {flops / tf / PEAK[name]:.3f} "
              f"of the {name} peak) | "
              f"write+topk overhead {(tf - ts) * 1e3:6.2f} ms", flush=True)
        del scores
        sync(device)
    return result


if __name__ == "__main__":
    main()

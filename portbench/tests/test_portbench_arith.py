"""The yardstick's arithmetic: percentiles and spreads, the bounds behind
the roofline shares, model FLOPs, the trace's busy time and spans."""

import math
import statistics

import numpy as np
import pytest

from portbench import core, flops, peaks, stats
from portbench.trace import Trace


def test_percentile_matches_numpy_and_counts_failures():
    xs = list(np.random.default_rng(0).exponential(size=101))
    for q in (50, 95, 99):
        assert stats.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)), rel=1e-12)
    assert stats.percentile(xs[:19] + [math.inf] * 2, 95) == math.inf
    assert math.isfinite(stats.percentile(xs[:99] + [math.inf], 50))


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def test_admissible_pairs_and_the_flash_bound():
    assert peaks.admissible_pairs([4], 4) == 10
    assert peaks.admissible_pairs([2], 4) == 3 + 2 * 2
    lengths, t, hq, hkv = [3584, 1000], 3584, 16, 2
    ops = 4 * hq * 128 * peaks.admissible_pairs(lengths, t)
    nbytes = 2 * t * 128 * 2 * (2 * hq + 2 * hkv) + 2 * t * 4
    assert peaks.flash_fwd_bound(lengths, t, hq, hkv) == pytest.approx(
        max(ops / peaks.BF16_OPS_PER_S, nbytes / peaks.HBM_BYTES_PER_S))
    # dq reads what the forward reads and more, and does 3/2 the products
    assert peaks.flash_dq_bound(lengths, t, hq, hkv) > \
        peaks.flash_fwd_bound(lengths, t, hq, hkv)


def test_taat_bound_is_bytes_bound_at_the_served_shape():
    t, by = peaks.bound(2 * 64 * 32 * 31784,
                        60 * 31784 * 2 + 32 * 64 * 8 + 32 * 31784 * 4,
                        peaks.F32_OPS_PER_S)
    assert by == "bytes"
    assert peaks.taat_bound(60, 64 * 32, 32, 64, 31784, 2) == \
        pytest.approx(t)


def test_decoder_flops_by_hand():
    cfg = core.config("qwen2_5_vl_7b")
    h, f, layers, v = 3584, 18944, 28, 152064
    per_layer = h * 3584 + 2 * h * 512 + 3584 * h + 3 * h * f
    assert flops.decoder_linear_params(cfg) == per_layer
    n = 40
    want = layers * (2 * per_layer * n + 4 * h * n * (n + 1) // 2) \
        + 2 * h * v
    assert flops.decoder_forward(cfg, [n]) == want
    # about 2 x parameters per token
    assert 2 * 6.5e9 < flops.decoder_forward(cfg, [1000]) / 1000 < 2 * 8e9


def test_vision_flops_scale_with_the_image():
    q = core.config("qwen2_5_vl_7b")
    assert flops.qwen_vit(q, 34, 46) > flops.qwen_vit(q, 24, 36)
    i = core.config("internvl2_5_4b")
    assert flops.internvit(i, 13) == pytest.approx(13 * flops.internvit(i, 1))
    # InternViT-300M: ~2 x 0.3e9 FLOPs a token of 1,025 a tile
    assert 2 * 0.25e9 < flops.internvit(i, 1) / 1025 < 2 * 0.45e9


def test_trace_busy_spans_and_gaps():
    tr = Trace(window_s=1e-4, t0_us=0.0)
    tr.kernels = [("gemm", 0.0, 10.0), ("gemm", 5.0, 20.0),
                  ("taat_kernel", 40.0, 50.0)]
    tr.spans = [("tower", 0.0, 30.0)]
    tr.cpu = [("tower", 0.0, 35.0, True), ("aten::mm", 21.0, 39.0, False)]
    assert tr.busy_s() == pytest.approx(30e-6)
    assert tr.span_s("tower") == (pytest.approx(25e-6), 1)
    assert tr.kernel_s("taat") == (pytest.approx(10e-6), 1)
    gaps = dict(tr.idle_gaps())
    assert gaps["tower"] == pytest.approx(20e-6)
    assert gaps["host"] == pytest.approx(50e-6)
    assert tr.device_ops()[0] == ["gemm", pytest.approx(25e-6)]

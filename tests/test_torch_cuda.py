"""PyTorch port on the card: the CUDA TAAT and flash-attention kernels
(forward, and the dq and dkv backward kernels) against their plain PyTorch
versions, the filtered TAAT top-k against the plain one, the fused hybrid
searcher against the host fuse, the tiny offline evaluation path on the
card against the same path on the CPU, and the search tiers: the bf16
dense search's peak memory, the SQ8 int8 product's padding, the compact48
wire through the TAAT kernel and the ANN tier, a converted checkpoint
loaded onto the card, the arena live index's in-place writes into the
TAAT kernel's matrix, tiny InternVL2.5 and Qwen2.5-VL encodes on the
card against the CPU, and the ``hostops`` extension built on the card's
machine against the Python bodies (the tolerances of all but the kernels
are in their docstrings). Marked ``cuda``; each test skips
where no card is present (decided inside the test, so every pytest worker
collects the same tests). This file
imports nothing of JAX, so it also runs where JAX is absent:

    pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: TAAT exact (integer weights, sums below 2^24). Flash forward,
at every query that has a real key at or before it, bf16 in and out on both
sides: the kernel rounds its unnormalised probabilities to bf16 and divides
at the end, the plain version normalises in f32 and then rounds, and each
output is rounded to bf16 (unit roundoff 2^-8). So each element lies within
``2^-7 * (|ref| + sum_s p_s |v_s|)`` of the plain one (the sum is the plain
version run on ``|v|``), and the mean abs err, which rounding keeps far
below that worst case (1.1e-4 against a mean ``|ref|`` of about 0.045 at
the served shape on an H100), stays under ``2^-7 * mean |ref|``. A query
with no admissible key gets exactly 0 from both. The forward's log-sum-exp
lies within ``1e-4 * (1 + |ref|)`` of ``torch.logsumexp`` of the plain f32
logits (the same bf16 inputs, f32 sums in another order) and is +inf where
there is no admissible key.

Backward: both sides round P to bf16 before a product and each gradient to
bf16 at the end; the plain version also rounds dP = dout . v to bf16, the
kernels round dS, and the two form di differently (the kernels from the
bf16 output). Each of those roundings moves a gradient by at most its unit
roundoff 2^-8 times the magnitudes of the terms it sums
(``flash_bwd_magnitudes``), di's up to twice that, so every element of dq,
dk and dv lies within ``2^-6 * (|ref| + magnitude)`` of the plain one and
the mean abs err under ``2^-6 * mean |ref|``. Where a gradient cancels to
0 (a query whose only key is itself: dS = P (dP - di) = 0 exactly, which
the plain version gets exactly and the kernels to rounding noise), the
mean is held instead to ``2^-6 * 2^-8 * mean magnitude``. On an H100 the
kernels' errors against an f64 computation from the same bf16 inputs were
as large as the plain version's (largest element shares 0.05-0.18).
"""

import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA
from mllm_sparse_retrieval_tpu_torch.ops import impact_kernel as K

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(seed, t, n, b, q, dtype, dev):
    rng = np.random.default_rng(seed)
    matrix = np.zeros((t + 1, n), np.float32)
    matrix[1:] = rng.integers(0, 350, size=(t, n))
    q_idx = rng.integers(0, t, size=(b, q))
    q_idx[:, 1] = q_idx[:, 0]                       # duplicate terms
    q_w = rng.integers(-20, 300, size=(b, q)).astype(np.float32)
    q_w[:, -5:] = 0.0                               # padding slots
    safe_idx, safe_w = K.prepare_query_arrays(q_idx, q_w)
    return (torch.from_numpy(matrix).to(dtype).to(dev),
            torch.from_numpy(safe_idx).to(dev), torch.from_numpy(safe_w).to(dev))


@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
@pytest.mark.parametrize("shape", [
    # (matrix rows, columns, batch, slots); the term split the wrapper picks
    # on a 132-SM card (taat_split) beside each. Duplicate, dead and padding
    # slots in every case.
    (50, 2048, 8, 12),         # split 8
    (300, 4104, 3, 300),       # split 8, two staging chunks of 256 slots
    (7, 8, 1, 2),              # split 8, one 8-column tile
    (20, 2048, 400, 16),       # split 1
    (50, 26624, 30, 64),       # split 2
    (50, 26624, 8, 64),        # split 4, the served batch and width
    (300, 4104, 8, 300),       # split 8, a last tile of 8 columns
    (300, 4104, 1, 64),        # split 8, one query
])
def test_kernel_equals_plain(dtype, shape):
    dev = _card()
    matrix, q_idx, q_w = _inputs(0, *shape, dtype, dev)
    before = K.launch_count()
    got = K.impact_scores_taat(matrix, q_idx, q_w)
    ref = K.impact_scores_taat_plain(matrix, q_idx, q_w)
    torch.cuda.synchronize()
    assert K.launch_count() == before + 1
    assert torch.equal(got, ref)


def test_kernel_skips_rows_outside_the_matrix():
    dev = _card()
    matrix = torch.ones((4, 16), dtype=torch.int16, device=dev)
    matrix[0] = 0
    q_idx = torch.tensor([[1, 4, -3, 0]], dtype=torch.int32, device=dev)
    q_w = torch.tensor([[2.0, 5.0, 5.0, 5.0]], device=dev)
    got = K.impact_scores_taat(matrix, q_idx, q_w)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.full((1, 16), 2.0, device=dev))


def test_kernel_rejects_what_it_does_not_take():
    dev = _card()
    matrix, q_idx, q_w = _inputs(1, 10, 16, 2, 4, torch.int16, dev)
    with pytest.raises(ValueError, match="% 8"):
        K.impact_scores_taat(matrix[:, :12].contiguous(), q_idx, q_w)
    with pytest.raises(ValueError, match="contiguous"):
        K.impact_scores_taat(matrix, q_idx.t().contiguous().t(), q_w)
    with pytest.raises(ValueError, match="devices"):
        K.impact_scores_taat(matrix, q_idx.cpu(), q_w)


FLASH_RTOL = 2.0 ** -7
BWD_RTOL = 2.0 ** -6
LSE_RTOL = 1e-4


def _has_key(mask):
    """[B, T] bool: the query has a real key at or before it."""
    return mask.bool().cumsum(dim=1) > 0


def _assert_flash_close(got, q, k, v, mask):
    ref = FA.flash_causal_attention_plain(q, k, v, mask).float()
    ref_abs = FA.flash_causal_attention_plain(q, k, v.abs(), mask).float()
    rows = _has_key(mask)
    assert torch.isfinite(got.float()).all()
    assert bool((got[~rows] == 0).all()) and bool((ref[~rows] == 0).all())
    diff = (got.float() - ref).abs()[rows]
    ref, ref_abs = ref.abs()[rows], ref_abs[rows]
    assert bool((diff <= FLASH_RTOL * (ref + ref_abs)).all())
    assert float(diff.mean()) <= FLASH_RTOL * float(ref.mean())


def _assert_grad_close(got, ref, mag, name):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all(), name
    diff = (got - ref).abs()
    assert bool((diff <= BWD_RTOL * (ref.abs() + mag)).all()), \
        (name, float(diff.max()))
    floor = float(mag.mean()) * 2.0 ** -8
    assert float(diff.mean()) <= BWD_RTOL * max(float(ref.abs().mean()),
                                                floor), name


def _flash_inputs(seed, b, t, hq, hkv, lengths, dev, dh=128):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, t, h, dh)).astype(
        np.float32)).to(dev, torch.bfloat16) for h in (hq, hkv, hkv))
    mask = np.zeros((b, t), np.int32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1                     # right padding
    return q, k, v, torch.from_numpy(mask).to(dev)


@pytest.mark.parametrize("shape", [
    # (b, t, hq, hkv, lengths): ragged rows, an all-pad row, T not a
    # multiple of the 64-row tile, MHA and GQA
    (3, 1024, 8, 2, (1024, 700, 0)),
    (2, 200, 4, 4, (137, 200)),
    (1, 64, 2, 1, (1,)),
])
def test_flash_kernel_matches_plain(shape):
    dev = _card()
    b, t, hq, hkv, lengths = shape
    q, k, v, mask = _flash_inputs(0, b, t, hq, hkv, lengths, dev)
    before = FA.launch_count()
    got = FA.flash_causal_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert FA.launch_count() == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    _assert_flash_close(got, q, k, v, mask)


def test_flash_kernel_reads_strided_views():
    dev = _card()
    q, k, v, mask = _flash_inputs(1, 2, 256, 4, 2, (256, 100), dev)
    qkv = torch.cat([q, k, v], dim=2)          # [B, T, 8, 128]: strided views
    qs, ks, vs = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = FA.flash_causal_attention(qs, ks, vs, mask)
    _assert_flash_close(got, q, k, v, mask)


def test_flash_kernel_rejects_what_it_does_not_take():
    dev = _card()
    q, k, v, mask = _flash_inputs(2, 1, 64, 2, 1, (64,), dev)
    before = FA.launch_count()
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_causal_attention(q[..., :64], k[..., :64], v[..., :64],
                                  mask)
    with pytest.raises(TypeError, match="bfloat16"):
        FA.flash_causal_attention(q.float(), k.float(), v.float(), mask)
    with pytest.raises(ValueError, match="last dimension"):
        qt = q.transpose(1, 3).contiguous().transpose(1, 3)
        FA.flash_causal_attention(qt, k, v, mask)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        kv3 = torch.cat([k, k, k], dim=2)
        FA.flash_causal_attention(q, kv3, kv3, mask)
    with pytest.raises(ValueError, match="devices"):
        FA.flash_causal_attention(q, k, v, mask.cpu())
    assert FA.launch_count() == before


@pytest.mark.parametrize("shape", [
    (3, 1024, 8, 2, (1024, 700, 0)),
    (2, 200, 4, 4, (137, 200)),
])
def test_flash_lse_matches_logsumexp(shape):
    dev = _card()
    b, t, hq, hkv, lengths = shape
    q, k, v, mask = _flash_inputs(5, b, t, hq, hkv, lengths, dev)
    out, lse = FA.flash_causal_attention_lse(q, k, v, mask)
    torch.cuda.synchronize()
    assert lse.shape == (b, hq, t) and lse.dtype == torch.float32
    assert torch.equal(out, FA.flash_causal_attention(q, k, v, mask))
    kr = k.float().repeat_interleave(hq // hkv, dim=2)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), kr) * 128 ** -0.5
    pos = torch.arange(t, device=dev)
    ok = (pos[:, None] >= pos[None, :])[None, None] \
        & mask.bool()[:, None, None, :]
    ref = torch.logsumexp(logits.masked_fill(~ok, float("-inf")), dim=-1)
    rows = _has_key(mask)[:, None, :].expand(-1, hq, -1)
    assert bool(torch.isinf(lse[~rows]).all()) and bool((lse[~rows] > 0).all())
    diff = (lse[rows] - ref[rows]).abs()
    assert bool((diff <= LSE_RTOL * (1 + ref[rows].abs())).all())


def _bwd_case(seed, b, t, hq, hkv, lengths, dev):
    q, k, v, mask = _flash_inputs(seed, b, t, hq, hkv, lengths, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dout = torch.randn(q.shape, generator=gen, device=dev,
                       dtype=torch.bfloat16)
    return q, k, v, mask, dout


def _assert_bwd_close(grads, q, k, v, mask, dout):
    ref = FA.flash_causal_attention_plain_bwd(q, k, v, mask, dout)
    mags = FA.flash_bwd_magnitudes(q, k, v, mask, dout)
    for name, got, r, m in zip(("dq", "dk", "dv"), grads, ref, mags):
        assert got.shape == r.shape and got.dtype == torch.bfloat16, name
        _assert_grad_close(got, r, m, name)


@pytest.mark.parametrize("shape", [
    # (b, t, hq, hkv, lengths): ragged rows and an all-pad row with GQA,
    # T not a multiple of the 64-row tile with MHA, one real token
    (3, 1024, 8, 2, (1024, 700, 0)),
    (2, 200, 4, 4, (137, 200)),
    (1, 64, 2, 1, (1,)),
])
def test_flash_bwd_kernels_match_plain(shape):
    dev = _card()
    b, t, hq, hkv, lengths = shape
    q, k, v, mask, dout = _bwd_case(6, b, t, hq, hkv, lengths, dev)
    out, lse = FA.flash_causal_attention_lse(q, k, v, mask)
    di = FA.flash_bwd_di(out, dout)
    before = {n: FA.launch_count(n) for n in FA.KERNELS}
    dq = FA.flash_attention_bwd_dq(q, k, v, mask, lse, di, dout)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, mask, lse, di, dout)
    torch.cuda.synchronize()
    assert {n: FA.launch_count(n) - before[n] for n in FA.KERNELS} == \
        {"fwd": 0, "dq": 1, "dkv": 1}
    _assert_bwd_close((dq, dk, dv), q, k, v, mask, dout)
    both = FA.flash_causal_attention_bwd(q, k, v, mask, out, lse, dout)
    for x, y in zip(both, (dq, dk, dv)):      # fixed sum order, no atomics
        assert torch.equal(x, y)


def test_flash_function_trains_through_the_kernels():
    dev = _card()
    q, k, v, mask, dout = _bwd_case(7, 2, 1024, 8, 2, (1024, 513), dev)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = {n: FA.launch_count(n) for n in FA.KERNELS}
    out = FA.FlashCausalAttention.apply(*leaves, mask, None)
    out.backward(dout)
    torch.cuda.synchronize()
    assert {n: FA.launch_count(n) - before[n] for n in FA.KERNELS} == \
        {"fwd": 1, "dq": 1, "dkv": 1}
    _assert_flash_close(out.detach(), q, k, v, mask)
    _assert_bwd_close([x.grad for x in leaves], q, k, v, mask, dout)
    with torch.no_grad():                     # no gradient wanted: no lse
        FA.FlashCausalAttention.apply(q, k, v, mask, None)
    assert FA.launch_count("fwd") - before["fwd"] == 2


def test_flash_bwd_reads_strided_views():
    dev = _card()
    q, k, v, mask, dout = _bwd_case(8, 2, 256, 4, 2, (256, 100), dev)
    qkv = torch.cat([q, k, v], dim=2)          # [B, T, 8, 128]: strided views
    qs, ks, vs = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    wide = torch.cat([dout, dout], dim=2)[:, :, :4]
    out, lse = FA.flash_causal_attention_lse(qs, ks, vs, mask)
    grads = FA.flash_causal_attention_bwd(qs, ks, vs, mask, out, lse, wide)
    _assert_bwd_close(grads, q, k, v, mask, dout)


def test_flash_bwd_rejects_what_it_does_not_take():
    dev = _card()
    q, k, v, mask, dout = _bwd_case(9, 1, 64, 2, 1, (64,), dev)
    out, lse = FA.flash_causal_attention_lse(q, k, v, mask)
    before = {n: FA.launch_count(n) for n in FA.KERNELS}
    with pytest.raises(TypeError, match="bfloat16"):
        FA.flash_causal_attention_bwd(q, k, v, mask, out, lse, dout.float())
    with pytest.raises(ValueError, match="last dimension"):
        dt = dout.transpose(1, 3).contiguous().transpose(1, 3)
        FA.flash_causal_attention_bwd(q, k, v, mask, out, lse, dt)
    with pytest.raises(ValueError, match="lse"):
        FA.flash_causal_attention_bwd(q, k, v, mask, out, lse[:, :1], dout)
    with pytest.raises(ValueError, match="di"):
        FA.flash_attention_bwd_dq(q, k, v, mask, lse, lse.double(), dout)
    with pytest.raises(ValueError, match="must match"):
        FA.flash_causal_attention_bwd(q, k, v, mask, out[:, :32],
                                      lse, dout)
    with pytest.raises(ValueError, match="devices"):
        FA.flash_causal_attention_bwd(q, k, v, mask.cpu(), out, lse, dout)
    with pytest.raises(ValueError, match="device"):
        FA.flash_causal_attention_lse(q.cpu(), k.cpu(), v.cpu(), mask.cpu())
    assert {n: FA.launch_count(n) for n in FA.KERNELS} == before


# The Hopper kernels on wgmma and TMA: 128-query items against 128-key
# tiles (forward, dq), 64-query tiles streamed through 128-key blocks (dkv).
# Shapes: (b, t, hq, hkv, lengths).
HOPPER_SHAPES = [
    (1, 1536, 8, 2, (1000,)),          # B=1, G=4, a row ending mid-tile
    (2, 1000, 4, 4, (1000, 0)),        # G=1, T not a tile multiple, all-pad
    (3, 200, 8, 2, (200, 77, 0)),      # T=200 (two ragged tiles), G=4
    (2, 1536, 4, 1, (1536, 1300)),     # one kv head for four query heads
]


@pytest.mark.parametrize("shape", HOPPER_SHAPES)
def test_hopper_forward_matches_plain(shape):
    dev = _card()
    b, t, hq, hkv, lengths = shape
    q, k, v, mask = _flash_inputs(11, b, t, hq, hkv, lengths, dev)
    out, lse = FA.flash_causal_attention_lse(q, k, v, mask)
    torch.cuda.synchronize()
    _assert_flash_close(out, q, k, v, mask)
    rows = _has_key(mask)[:, None, :].expand(-1, hq, -1)
    assert bool((lse[~rows] == float("inf")).all())   # exactly where no key
    assert bool(torch.isfinite(lse[rows]).all())


@pytest.mark.parametrize("shape", HOPPER_SHAPES)
def test_hopper_dkv_matches_plain_and_repeats_bit_for_bit(shape):
    dev = _card()
    b, t, hq, hkv, lengths = shape
    q, k, v, mask, dout = _bwd_case(12, b, t, hq, hkv, lengths, dev)
    out, lse = FA.flash_causal_attention_lse(q, k, v, mask)
    di = FA.flash_bwd_di(out, dout)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, mask, lse, di, dout)
    dk2, dv2 = FA.flash_attention_bwd_dkv(q, k, v, mask, lse, di, dout)
    torch.cuda.synchronize()
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    _, ref_k, ref_v = FA.flash_causal_attention_plain_bwd(q, k, v, mask, dout)
    _, mag_k, mag_v = FA.flash_bwd_magnitudes(q, k, v, mask, dout)
    _assert_grad_close(dk, ref_k, mag_k, "dk")
    _assert_grad_close(dv, ref_v, mag_v, "dv")
    real = mask.bool()[:, :, None, None]
    assert bool((dk.masked_select(~real) == 0).all())   # pad keys: no query
    assert bool((dv.masked_select(~real) == 0).all())


@pytest.mark.parametrize("shape", HOPPER_SHAPES)
def test_hopper_dq_matches_plain_and_repeats_bit_for_bit(shape):
    dev = _card()
    b, t, hq, hkv, lengths = shape
    q, k, v, mask, dout = _bwd_case(15, b, t, hq, hkv, lengths, dev)
    out, lse = FA.flash_causal_attention_lse(q, k, v, mask)
    di = FA.flash_bwd_di(out, dout)
    dq = FA.flash_attention_bwd_dq(q, k, v, mask, lse, di, dout)
    dq2 = FA.flash_attention_bwd_dq(q, k, v, mask, lse, di, dout)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2)                 # fixed order, no atomics
    ref_q, _, _ = FA.flash_causal_attention_plain_bwd(q, k, v, mask, dout)
    mag_q, _, _ = FA.flash_bwd_magnitudes(q, k, v, mask, dout)
    _assert_grad_close(dq, ref_q, mag_q, "dq")
    rows = _has_key(mask)[:, :, None, None]
    assert bool((dq.masked_select(~rows) == 0).all())   # no admissible key


def test_hopper_kernels_read_a_broadcast_kv_head():
    dev = _card()
    q, k, v, mask, dout = _bwd_case(13, 2, 256, 4, 2, (256, 130), dev)
    kb, vb = k[:1].expand(2, -1, -1, -1), v[:1].expand(2, -1, -1, -1)
    out, lse = FA.flash_causal_attention_lse(q, kb, vb, mask)
    _assert_flash_close(out, q, kb.contiguous(), vb.contiguous(), mask)
    grads = FA.flash_causal_attention_bwd(q, kb, vb, mask, out, lse, dout)
    _assert_bwd_close(grads, q, kb.contiguous(), vb.contiguous(), mask, dout)


@pytest.mark.parametrize("scale", [0.03, -0.05])
def test_hopper_forward_takes_any_scale(scale):
    dev = _card()
    q, k, v, mask = _flash_inputs(14, 2, 384, 4, 2, (384, 250), dev)
    got = FA.flash_causal_attention(q, k, v, mask, scale=scale)
    ref = FA.flash_causal_attention_plain(q, k, v, mask, scale=scale).float()
    ref_abs = FA.flash_causal_attention_plain(q, k, v.abs(), mask,
                                              scale=scale).float()
    torch.cuda.synchronize()
    rows = _has_key(mask)
    diff = (got.float() - ref).abs()[rows]
    assert bool((diff <= FLASH_RTOL * (ref.abs()[rows] + ref_abs[rows]))
                .all())


def test_flash_forward_at_the_vicuna_width_g1():
    """LLaVA-1.6-Vicuna's image prompts: 32 query heads on 32 KV heads
    (G = 1) at 3,072 tokens, one all-pad row."""
    dev = _card()
    q, k, v, mask = _flash_inputs(17, 2, 3072, 32, 32, (2911, 0), dev)
    before = FA.launch_count()
    got = FA.flash_causal_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert FA.launch_count() == before + 1
    _assert_flash_close(got, q, k, v, mask)


def test_flash_forward_at_the_internvl_width_g7():
    """InternVL2.5-8B's image prompts: 28 query heads on 4 KV heads (G = 7,
    an odd number of query heads a KV head) at 3,584 tokens, one all-pad
    row."""
    dev = _card()
    q, k, v, mask = _flash_inputs(18, 2, 3584, 28, 4, (3371, 0), dev)
    before = FA.launch_count()
    got = FA.flash_causal_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert FA.launch_count() == before + 1
    _assert_flash_close(got, q, k, v, mask)


def test_flash_bwd_at_the_internvl_width_g7():
    """The dq and dkv kernels at InternVL2.5-8B's training shape: 28 query
    heads on 4 KV heads (G = 7: dkv sums seven query heads a KV head) at
    3,584 tokens, a ragged row and an all-pad row, against the plain
    backward."""
    dev = _card()
    q, k, v, mask, dout = _bwd_case(19, 2, 3584, 28, 4, (3371, 0), dev)
    out, lse = FA.flash_causal_attention_lse(q, k, v, mask)
    di = FA.flash_bwd_di(out, dout)
    before = {n: FA.launch_count(n) for n in FA.KERNELS}
    dq = FA.flash_attention_bwd_dq(q, k, v, mask, lse, di, dout)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, mask, lse, di, dout)
    torch.cuda.synchronize()
    assert {n: FA.launch_count(n) - before[n] for n in FA.KERNELS} == \
        {"fwd": 0, "dq": 1, "dkv": 1}
    _assert_bwd_close((dq, dk, dv), q, k, v, mask, dout)


def test_hostops_builds_and_equals_the_python_bodies():
    """On the card's machine (its compiler and ``Python.h``): the extension
    builds and loads, and run assembly, fusion, the live merge and the
    query encode of an index on the card equal the Python bodies."""
    dev = _card()
    from mllm_sparse_retrieval_tpu_torch import hostops
    from mllm_sparse_retrieval_tpu_torch.index import impact as impact_mod
    from mllm_sparse_retrieval_tpu_torch.index import live
    from mllm_sparse_retrieval_tpu_torch.search import fusion, runs
    from mllm_sparse_retrieval_tpu_torch.sparse import SelectedTerms

    assert hostops.get().path == hostops.build()
    rng = np.random.default_rng(4)
    qids = [f"q{i}" for i in range(16)]
    made = []
    for _ in range(2):
        scores = [sorted(rng.normal(size=int(rng.integers(0, 12))).tolist(),
                         reverse=True) for _ in qids]
        ids = [[f"d{int(x)}" for x in rng.integers(0, 40, len(r))]
               for r in scores]
        hostops.reset_call_counts()
        run = runs.make_run(qids, scores, ids, scores_sorted=True)
        assert hostops.call_counts()["build_runs"] == 1
        assert run == runs._make_run_python(qids, scores, ids, False, True)
        made.append(run)
    assert fusion.fuse(made, [0.4, 0.6]) == \
        fusion._fuse_python(made, [0.4, 0.6])
    segs = [live._Segment(None, set(), {"d1", "d2"}, 0) for _ in range(3)]
    per = [([[float(x) for x in rng.integers(0, 5, 6)] for _ in qids],
            [[f"d{int(x)}" for x in rng.integers(0, 9, 6)] for _ in qids])
           for _ in segs]
    assert live._merge_rows(per, segs, 4) == live._merge_rows_python(
        per, [s.tombstones for s in segs], [0, 0, 0], 4)
    index = impact_mod.ImpactIndex.from_packed_arrays(
        rng.integers(0, 90, (30, 6)).astype(np.int32),
        rng.integers(1, 40, (30, 6)).astype(np.float32),
        term_keys=range(90), device=dev)
    rows = [SelectedTerms(rng.integers(-3, 120, 10).astype(np.int32),
                          rng.integers(-2, 30, 10).astype(np.int32))
            for _ in range(8)]
    hostops.reset_call_counts()
    got = index.encode_query_terms(rows)
    assert hostops.call_counts()["encode_terms"] == 1
    want = index.encode_query_terms([SelectedTerms(
        r.token_ids.astype(np.int64), r.weights.astype(np.int64))
        for r in rows])                    # int64 rows: the numpy body
    assert hostops.call_counts()["encode_terms"] == 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", ["internvl", "qwen"])
def test_chat_family_encode_on_the_card_equals_the_cpu(family):
    """A tiny InternVL2.5 (dynamic tiles) and Qwen2.5-VL (native
    resolution, M-RoPE ids) image encode in f32 on the card and on the CPU
    from the same weights and inputs: sparse and dense reps within
    ``1e-4 * (1 + |cpu|)`` (f32 both, sums in another order)."""
    dev = _card()
    from mllm_sparse_retrieval_tpu_torch.models import api, registry
    from mllm_sparse_retrieval_tpu_torch.models.internvl import (
        InternViTConfig, InternVLConfig)
    from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
    from mllm_sparse_retrieval_tpu_torch.models.qwen_vl import (
        QwenViTConfig, QwenVLConfig)

    text = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                num_kv_heads=2, intermediate_size=128, rope_theta=1e6,
                qkv_bias=True)
    if family == "internvl":
        arch = InternVLConfig(
            vision=InternViTConfig(hidden_size=32, num_layers=2, num_heads=4,
                                   intermediate_size=64, image_size=56),
            text=LlamaConfig(**text), image_token_id=120,
            max_dynamic_tiles=4)
    else:
        arch = QwenVLConfig(
            vision=QwenViTConfig(hidden_size=64, depth=2, num_heads=4,
                                 intermediate_size=128, out_hidden_size=64,
                                 window_size=56, fullatt_block_indexes=(1,)),
            text=LlamaConfig(**text, mrope_section=(4, 2, 2)),
            image_token_id=120, native_resolution=True,
            max_pixels=16 * 28 * 28)
    params = registry.init_params(
        arch, torch.Generator().manual_seed(0), "cpu", torch.float32)
    spec = api.image_input_spec(arch)
    rng = np.random.default_rng(3)
    items = [spec.preprocess_example(rng.uniform(size=hw + (3,)).astype(
        np.float32)) for hw in ((90, 140), (160, 50))]
    t = max(n for _, n in items) + 8
    ids = np.zeros((2, t), np.int64)
    mask = np.zeros((2, t), np.int32)
    for i, (_, n) in enumerate(items):
        row = [1, 5] + [120] * n + [7, 9]
        ids[i, :len(row)], mask[i, :len(row)] = row, 1
    vision = spec.batch_vision([it for it, _ in items])
    pos = (spec.mrope_from_batch(ids, mask, vision)
           if spec.mrope_from_batch else None)

    def run(device):
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        p = _tree_map(lambda x: x.to(device), params)
        px = ({k: put(v) for k, v in vision.items()}
              if isinstance(vision, dict) else put(vision))
        with torch.inference_mode():
            out = api.encode_any(p, arch, put(ids), put(mask), px,
                                 position_ids=None if pos is None
                                 else put(pos))
        return [x.float().cpu().numpy() for x in out]

    for got, ref in zip(run(dev), run("cpu")):
        assert np.all(np.abs(got - ref) <= 1e-4 * (1 + np.abs(ref)))


def _tree_map(fn, tree):
    """``fn`` over the tensor leaves of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_load_converted_onto_the_card_equals_the_cpu_load(tmp_path, dtype):
    """A converted checkpoint (``params.pkl`` + ``arch.json``) loads onto the
    card bit for bit as onto the CPU, every tensor contiguous there."""
    dev = _card()
    import json
    import pickle

    from mllm_sparse_retrieval_tpu_torch.configs import ModelConfig
    from mllm_sparse_retrieval_tpu_torch.models import convert, mllm
    from mllm_sparse_retrieval_tpu_torch.models.registry import (
        tiny_debug_arch)

    arch = tiny_debug_arch(ModelConfig())
    drawn = mllm.init_params(arch, torch.Generator().manual_seed(0), "cpu",
                             torch.float32)

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [host(v) for v in tree]
        return tree.numpy().T.copy().T if tree.ndim == 2 else tree.numpy()

    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(host(drawn), f)  # 2-D leaves column-major, as converted
    (tmp_path / "arch.json").write_text(json.dumps(
        convert.arch_to_manifest(arch)))
    cpu, _, cpu_arch = convert.load_converted(str(tmp_path), None, dtype,
                                              "cpu")
    card, tok, card_arch = convert.load_converted(str(tmp_path), None, dtype,
                                                  dev)
    assert cpu_arch == card_arch == arch and tok is None

    def pairs(a, b):
        if isinstance(a, dict):
            for key in a:
                yield from pairs(a[key], b[key])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                yield from pairs(x, y)
        else:
            yield a, b

    n = 0
    for c, g in pairs(cpu, card):
        assert g.device.type == "cuda" and g.dtype == dtype
        assert g.is_contiguous() and g.shape == c.shape
        assert torch.equal(g.cpu(), c)
        n += 1
    assert n > 20


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


def test_offline_path_on_the_card_matches_the_cpu(tmp_path):
    """The tiny offline path (``encode_examples`` -> ``write_artifacts`` ->
    ``ImpactIndex.from_jsonl`` (native) -> ``run_search``, hybrid) on the
    card and on the CPU, one f32 model: the card run launches the TAAT
    kernel; selected terms, the sparse jsonl and the sparse runs are exact
    (integer weights), dense vectors and dense scores within 1e-5 (f32
    matmuls summed in another order, TF32 off), runs compared as
    ``(doc, score)`` sets up to docs tied at the depth cut."""
    dev = _card()
    from mllm_sparse_retrieval_tpu_torch.configs import (
        ModelConfig, ModelFamily, SearchConfig, SparseConfig)
    from mllm_sparse_retrieval_tpu_torch.data import CrossModalCorpus
    from mllm_sparse_retrieval_tpu_torch.index import (
        DenseFlatIndex, ImpactIndex)
    from mllm_sparse_retrieval_tpu_torch.models import build_model
    from mllm_sparse_retrieval_tpu_torch.pipelines.encode import (
        encode_examples, write_artifacts)
    from mllm_sparse_retrieval_tpu_torch.search.engine import run_search

    rng = np.random.default_rng(8)
    words = ["dog", "cat", "red", "bus", "man", "kite", "boat", "lake",
             "snow", "child", "bird", "wire", "grass", "city", "tree"]
    lines = ["imgid,filename,caption,sentid"]
    for i in range(10):
        for c in range(3):
            lines.append(f"{i},{i}.jpg,a {' '.join(rng.choice(words, 5))},"
                         f"{3 * i + c}")
    (tmp_path / "flickr").mkdir()
    (tmp_path / "flickr" / "flickr_test.csv").write_text(
        "\n".join(lines) + "\n")
    corpus = CrossModalCorpus("flickr", "test", str(tmp_path))
    params, arch, tok, tmpl = build_model(
        ModelConfig(family=ModelFamily.TINY_DEBUG, dtype="float32"),
        captions=list(corpus.text_dict.values()), device="cpu")
    out = []
    for where, p in (("cpu", params), (dev, _to_device(params, dev))):
        enc = encode_examples(corpus.examples_single(), p, arch, tok, tmpl,
                              encode_type="image", sparse_cfg=SparseConfig(),
                              batch_size=4, device=where)
        root = tmp_path / f"run{len(out)}"
        write_artifacts(enc, str(root / "dense"), str(root / "sparse"))
        index = ImpactIndex.from_jsonl([str(root / "sparse" /
                                            "corpus_0.jsonl")], device=where)
        K.reset_launch_count()
        res = run_search(
            corpus.examples_full(), p, arch, tok, tmpl, query_type="text",
            sparse_cfg=SparseConfig(), search_cfg=SearchConfig(depth=6),
            dense_index=DenseFlatIndex.load(str(root / "dense"),
                                            device=where),
            impact_index=index, batch_size=8,
            get_target=lambda q: corpus.get_target(q, "text"), device=where)
        out.append((enc, res, K.launch_count(),
                    (root / "sparse" / "corpus_0.jsonl").read_text()))
    (c_enc, c_res, c_taat, c_jsonl), (g_enc, g_res, g_taat, g_jsonl) = out
    assert g_taat >= 1 and c_taat == 0
    assert g_enc.ids == c_enc.ids and g_jsonl == c_jsonl
    np.testing.assert_allclose(g_enc.dense, c_enc.dense, atol=1e-5,
                               rtol=1e-5)
    for name, tol in (("dense_run", 1e-5), ("sparse_run", 0.0)):
        g, c = getattr(g_res, name), getattr(c_res, name)
        assert set(g) == set(c)
        for q in g:
            a = sorted(g[q]["docs"].items(), key=lambda kv: -kv[1])
            b = dict(c[q]["docs"])
            assert len(a) == len(b)
            cut = a[-1][1] + 2 * tol if len(a) == 6 else -np.inf
            for doc, s in a:
                if s > cut:
                    assert doc in b and abs(b[doc] - s) <= tol + 1e-12
    assert set(g_res.fusion_run) == set(c_res.fusion_run)
    assert g_res.summary().count("recall") == 3


@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
def test_filtered_taat_topk_equals_plain(dtype):
    """The filtered TAAT top-k on the card (kernel scores, -inf for the
    columns the mask excludes, top-k) against the same program on the
    CPU (the plain scores): equal scores exactly (integer weights), equal
    doc sets up to docs tied at the cut, no excluded or padding column."""
    dev = _card()
    from mllm_sparse_retrieval_tpu_torch.ops import score_programs as SP
    from mllm_sparse_retrieval_tpu_torch.ops.packing import unpack_topk

    rng = np.random.default_rng(11)
    t, n_pad, n_valid, b, q, k = 300, 26624, 25010, 8, 64, 100
    matrix = np.zeros((t + 1, n_pad), np.float32)
    matrix[1:, :n_valid] = rng.integers(0, 350, size=(t, n_valid))
    q_idx = rng.integers(0, t, size=(b, q)).astype(np.int32)
    q_w = rng.integers(-5, 300, size=(b, q)).astype(np.float32)
    mask = rng.random(n_pad) < 0.1
    mask[n_valid:] = True                 # padding columns stay out anyway
    out = []
    for where in ("cpu", dev):
        K.reset_launch_count()
        packed = SP._taat_topk(
            torch.from_numpy(matrix).to(dtype).to(where),
            torch.from_numpy(q_idx).to(where),
            torch.from_numpy(q_w).to(where), n_valid, k,
            torch.from_numpy(mask).to(where))
        out.append((unpack_topk(packed.cpu().numpy()), K.launch_count()))
    ((cs, ci), c_n), ((gs, gi), g_n) = out
    assert (c_n, g_n) == (0, 1)
    np.testing.assert_array_equal(gs, cs)
    for r in range(b):
        assert mask[gi[r]].all() and (gi[r] < n_valid).all()
        above = gs[r] > gs[r, -1]
        assert set(gi[r][above]) == set(ci[r][above])


def test_fused_searcher_on_the_card_equals_host_fuse():
    """``FusedHybridSearcher`` on the card (TAAT kernel, f32 MIPS with TF32
    off, fusion) against ``search.fusion.fuse`` (float64) of the two
    engines' own runs on the card: the same doc sets over the whole union,
    fused scores within 1e-5."""
    dev = _card()
    from mllm_sparse_retrieval_tpu_torch.index import (
        DenseFlatIndex, ImpactIndex)
    from mllm_sparse_retrieval_tpu_torch.search.device_fusion import (
        FusedHybridSearcher)
    from mllm_sparse_retrieval_tpu_torch.search.fusion import fuse
    from mllm_sparse_retrieval_tpu_torch.search.runs import make_run

    rng = np.random.default_rng(12)
    n_docs, dim, n_terms, n_q, depth = 3000, 64, 500, 20, 50
    doc_ids = [f"d{i}" for i in range(n_docs)]
    impact = ImpactIndex(device=dev)
    for d in doc_ids:
        terms = rng.choice(n_terms, size=rng.integers(5, 30), replace=False)
        impact.add(d, {int(x): int(rng.integers(1, 300)) for x in terms})
    impact.finalize()
    order = rng.permutation(n_docs)
    reps = rng.normal(size=(n_docs, dim)).astype(np.float32)
    dense = DenseFlatIndex(device=dev)
    dense.add(reps[order], [doc_ids[i] for i in order])
    q_reps = rng.normal(size=(n_q, dim)).astype(np.float32)
    q_dicts = [{int(x): int(rng.integers(1, 10))
                for x in rng.choice(n_terms, 20, replace=False)}
               for _ in range(n_q)]
    qids = [doc_ids[7 * i] for i in range(n_q)]
    q_idx, q_w = impact.encode_queries(q_dicts)
    K.reset_launch_count()
    run = FusedHybridSearcher(dense, impact, alpha=0.4).search_run(
        q_reps, q_idx, q_w, qids, depth, remove_query=True,
        out_depth=2 * depth)
    assert K.launch_count() == 1
    d_s, d_i = dense.search_ids(q_reps, depth)
    s_s, s_i = impact.search_encoded(q_idx, q_w, depth, backend="taat")
    host = fuse([make_run(qids, d_s.tolist(), d_i, remove_query=True,
                          scores_sorted=True),
                 make_run(qids, s_s, s_i, remove_query=True,
                          scores_sorted=True)], [0.4, 0.6])
    assert set(run) == set(host)
    for q in run:
        assert set(run[q]) == set(host[q]) and q not in run[q]
        for doc, s in host[q].items():
            assert abs(run[q][doc] - s) <= 1e-5, (q, doc)


def test_bf16_search_holds_no_f32_copy_of_the_corpus():
    """A bf16 dense search on the card is one bf16 GEMM with f32 output:
    its peak device memory stays within the memory allocated before it (the
    bf16 corpus included) plus the ``[B, N]`` f32 score tensor plus a slack
    of two of the CPU route's widening chunks (``mips._WIDEN_BYTES`` each)
    and 8 MiB. An f32 copy of the whole corpus (328 MB here) would break
    it. Each score lies within ``d * 2^-24 * sum |q c|`` of the float64
    product of the same bf16 values (exact products, f32 sums)."""
    dev = _card()
    from mllm_sparse_retrieval_tpu_torch.index import DenseFlatIndex
    from mllm_sparse_retrieval_tpu_torch.ops import mips

    rng = np.random.default_rng(13)
    n, d, b = 20_000, 4096, 8
    index = DenseFlatIndex(dtype=torch.bfloat16, device=dev)
    corpus = rng.standard_normal((n, d), dtype=np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    index.add(corpus, [str(i) for i in range(n)])
    q = corpus[:b] + 0.01
    index.search(q, 10)                     # warm-up: cuBLAS workspace
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    scores, _ = index.search(q, 10)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    slack = 2 * mips._WIDEN_BYTES + 8 * 2 ** 20
    assert peak - before <= b * n * 4 + slack, (peak - before) / 2 ** 20
    assert index._corpus_dev.dtype == torch.bfloat16
    qd = torch.from_numpy(q).to(dev).bfloat16().double()
    ref = qd @ index._corpus_dev.double().T
    bound = d * 2.0 ** -24 * (qd.abs() @ index._corpus_dev.double().abs().T)
    got = mips.mips_scores(torch.from_numpy(q).to(dev), index._corpus_dev)
    assert got.dtype == torch.float32
    assert bool(((got.double() - ref).abs() <= bound).all())
    top = torch.topk(ref, 10, dim=1).values.cpu().numpy()
    np.testing.assert_allclose(scores, top, rtol=0,
                               atol=float(bound.max()))


@pytest.mark.parametrize("b", [1, 8, 17, 40])
def test_int8_product_pads_for_the_card(b):
    """``_int_mm`` on the card takes more than 16 rows and widths that are
    multiples of 8: the query rows pad to 32 and the SQ8 index pads its
    corpus once. The int32 products equal an int64 numpy product exactly,
    and the SQ8 index on the card equals the same index on the CPU bit for
    bit (integer products, one f32 dequantization)."""
    dev = _card()
    from mllm_sparse_retrieval_tpu_torch.index import DenseFlatIndex
    from mllm_sparse_retrieval_tpu_torch.ops import mips

    rng = np.random.default_rng(14)
    q8 = rng.integers(-127, 128, size=(b, 104)).astype(np.int8)
    c8 = rng.integers(-127, 128, size=(1008, 104)).astype(np.int8)
    acc = mips._int8_matmul(torch.from_numpy(q8).to(dev),
                            torch.from_numpy(c8).to(dev))
    assert acc.shape == (b, 1008) and acc.dtype == torch.int32
    np.testing.assert_array_equal(
        acc.cpu().numpy(), q8.astype(np.int64) @ c8.astype(np.int64).T)
    with pytest.raises(ValueError, match="multiples of 8"):
        mips._int8_matmul(torch.from_numpy(q8).to(dev),
                          torch.from_numpy(c8[:1001]).to(dev))
    corpus = rng.standard_normal((1001, 100), dtype=np.float32)
    ids = [str(i) for i in range(1001)]
    out = []
    for where in ("cpu", dev):
        index = DenseFlatIndex(dtype=torch.int8, device=where)
        index.add(corpus, ids)
        out.append(index.search_ids(corpus[:b] + 0.1, 20, batch_size=b))
    (cs, ci), (gs, gi) = out
    np.testing.assert_array_equal(gs, cs)
    for r in range(b):
        above = gs[r] > gs[r, -1]
        assert {d for d, a in zip(gi[r], above) if a} == \
            {d for d, a in zip(ci[r], above) if a}


def test_compact48_on_the_kernel_equals_i32_and_the_cpu():
    """``wire="compact48"`` through the TAAT kernel, filtered and not:
    the same (score, id) sets as the i32 wire on the card and as the
    matmul backend on the CPU, one kernel launch per search chunk."""
    dev = _card()
    from mllm_sparse_retrieval_tpu_torch.index import DocFilter, ImpactIndex

    rng = np.random.default_rng(15)
    n_docs, n_terms = 25_010, 2000
    doc_t = np.stack([rng.choice(n_terms, 40, replace=False)
                      for _ in range(n_docs)]).astype(np.int32)
    doc_w = rng.integers(1, 350, size=(n_docs, 40)).astype(np.float32)
    ids = [f"d{i}" for i in range(n_docs)]
    gpu = ImpactIndex.from_packed_arrays(doc_t, doc_w, ids, range(n_terms),
                                         device=dev)
    cpu = ImpactIndex.from_packed_arrays(doc_t, doc_w, ids, range(n_terms),
                                         device="cpu")
    q_i = rng.integers(0, n_terms, size=(8, 64)).astype(np.int32)
    q_w = rng.integers(1, 300, size=(8, 64)).astype(np.float32)
    keep = ids[::10]

    def sets(res):
        return [{(s, d) for s, d in zip(sr, ir)} for sr, ir in zip(*res)]

    for flt in (None, keep):
        g_f = None if flt is None else DocFilter.from_ids(ids, flt)
        c_f = None if flt is None else DocFilter.from_ids(ids, flt)
        K.reset_launch_count()
        got = gpu.search_encoded(q_i, q_w, n_docs, backend="taat",
                                 wire="compact48", doc_filter=g_f)
        assert K.launch_count() == 1
        i32 = gpu.search_encoded(q_i, q_w, n_docs, backend="taat",
                                 doc_filter=g_f)
        ref = cpu.search_encoded(q_i, q_w, n_docs, backend="matmul",
                                 wire="compact48", doc_filter=c_f)
        assert sets(got) == sets(i32) == sets(ref)
        assert max(max(r) for r in got[0]) > 65536


def test_ann_on_the_card_matches_the_cpu():
    """``DenseANNIndex`` on the card (stage 1 and the rescore in full f32,
    TF32 off) against the same index on the CPU: the same ids up to docs
    tied within 1e-5 at the cut, scores within 1e-5."""
    dev = _card()
    from mllm_sparse_retrieval_tpu_torch.index import DenseANNIndex

    rng = np.random.default_rng(16)
    u = rng.normal(size=(5000, 16))
    basis = np.linalg.qr(rng.normal(size=(256, 16)))[0]
    corpus = (u @ basis.T + 0.02 * rng.normal(size=(5000, 256))).astype(
        np.float32)
    q = corpus[:8] + 0.01
    ids = [str(i) for i in range(5000)]
    out = []
    for where in ("cpu", dev):
        index = DenseANNIndex(device=where, rank=32, candidates=256)
        index.add(corpus, ids)
        out.append(index.search_ids(q, 10, batch_size=8))
    (cs, ci), (gs, gi) = out
    np.testing.assert_allclose(gs, cs, rtol=0, atol=1e-5)
    for r in range(8):
        cut = gs[r, -1] + 2e-5
        assert {d for d, s in zip(gi[r], gs[r]) if s > cut} <= set(ci[r])


def _arena_workload(device, seed=0):
    """One arena on ``device`` through adds (past the headroom once),
    replaces, deletes and an add of a weight past int16, searched with the
    TAAT backend after each step -> (results per step, final matrices)."""
    from mllm_sparse_retrieval_tpu_torch.index import (
        ArenaImpactIndex, ImpactIndex)

    rng = np.random.default_rng(seed)
    vocab = np.arange(400)

    def docs(ids):
        return [(d, {int(t): int(w) for t, w in zip(
            rng.choice(vocab, 12, replace=False), rng.integers(1, 300, 12))})
            for d in ids]

    base = ImpactIndex(device=device)
    base.add_many(docs([f"b{i}" for i in range(3000)]))
    arena = ArenaImpactIndex(base, doc_headroom=2048, term_headroom=64,
                             device=device)
    queries = [{int(t): int(w) for t, w in zip(
        rng.choice(vocab, 16, replace=False), rng.integers(1, 4, 16))}
        for _ in range(8)]
    out = [arena.search_rows(queries, 50, backend="taat")]
    for step, n in enumerate((500, 1000, 1500)):   # the last one grows
        arena.add_documents(docs([f"n{step}_{i}" for i in range(n)]) +
                            [(f"b{step}", {1: 7, 2: 5})])
        arena.delete_documents([f"b{100 + i}" for i in range(50 * step,
                                                              50 * step + 40)])
        out.append(arena.search_rows(queries, 50, backend="taat"))
    arena.add_documents([("big", {int(vocab[0]): 40_000})])
    out.append(arena.search_rows(queries, 50, backend="taat"))
    return out, {k: v.float().cpu().numpy()
                 for k, v in arena._inner._dev.items()}


def test_arena_on_the_card_equals_the_cpu():
    """Adds, replaces, deletes, a grow and the int16 drop on the card give
    the CPU's matrices exactly and its results up to ties at the cut."""
    device = _card()
    got, got_dev = _arena_workload(device)
    want, want_dev = _arena_workload("cpu")
    assert sorted(got_dev) == sorted(want_dev) == ["f32"]
    for key in got_dev:
        assert np.array_equal(got_dev[key], want_dev[key]), key
    for (gs, gi), (ws, wi) in zip(got, want):
        assert gs == ws
        for s_row, i_row, w_row, wi_row in zip(gs, gi, ws, wi):
            low = s_row[-1] if s_row else None
            assert {i for i, s in zip(i_row, s_row) if s != low} == \
                {i for i, s in zip(wi_row, w_row) if s != low}


def test_taat_on_a_scatter_mutated_capacity_matrix_equals_plain():
    """The kernel on the arena's capacity-padded int16 matrix after
    in-place adds and deletes (same storage) equals its plain version."""
    device = _card()
    from mllm_sparse_retrieval_tpu_torch.index import (
        ArenaImpactIndex, ImpactIndex)

    rng = np.random.default_rng(1)
    base = ImpactIndex(device=device)
    base.add_many((f"b{i}", {int(t): int(w) for t, w in zip(
        rng.choice(2000, 32, replace=False), rng.integers(1, 300, 32))})
        for i in range(5000))
    arena = ArenaImpactIndex(base, device=device)
    arena.search_rows([{1: 1}], 10, backend="taat")
    matrix = arena._inner._dev["i16"]
    ptr = matrix.data_ptr()
    arena.add_documents([(f"n{i}", {int(t): int(w) for t, w in zip(
        rng.choice(2100, 32, replace=False), rng.integers(1, 300, 32))})
        for i in range(1024)])
    arena.delete_documents([f"b{i}" for i in range(0, 5000, 7)])
    assert arena._inner._dev["i16"].data_ptr() == ptr
    assert matrix.shape[1] % K.COLS_ALIGN == 0 and ptr % 16 == 0
    q_idx = torch.from_numpy(rng.integers(
        1, matrix.shape[0], (8, 128)).astype(np.int32)).to(device)
    q_w = torch.from_numpy(rng.integers(1, 5, (8, 128)).astype(
        np.float32)).to(device)
    torch.testing.assert_close(K.impact_scores_taat(matrix, q_idx, q_w),
                               K.impact_scores_taat_plain(matrix, q_idx, q_w),
                               rtol=0, atol=0)


def test_scatter_from_another_thread_never_returns_a_deleted_id():
    """A writer thread adds and deletes while a search stream is in flight
    on the main thread: no search that started after a delete returned
    serves the deleted id, and both threads end in time."""
    import threading

    device = _card()
    from mllm_sparse_retrieval_tpu_torch.index import (
        ArenaImpactIndex, ImpactIndex)

    rng = np.random.default_rng(2)
    vocab = np.arange(300)
    base = ImpactIndex(device=device)
    base.add_many((f"b{i}", {int(t): 5 for t in rng.choice(
        vocab, 16, replace=False)}) for i in range(4000))
    arena = ArenaImpactIndex(base, device=device)
    queries = [{int(t): 1 for t in rng.choice(vocab, 32, replace=False)}
               for _ in range(16)]
    deleted, errors, stop = set(), [], threading.Event()

    def writer():
        try:
            wrng = np.random.default_rng(3)
            for step in range(60):
                arena.add_documents([(f"w{step}_{i}", {int(t): 9 for t in
                                      wrng.choice(vocab, 16, replace=False)})
                                     for i in range(32)])
                victims = [f"b{step * 20 + i}" for i in range(20)]
                arena.delete_documents(victims)
                deleted.update(victims)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        finally:
            stop.set()

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    searches = 0
    while not stop.is_set() and not errors:
        gone = set(deleted)             # deletes that have returned
        _, ids = arena.search_rows(queries, 4000, backend="taat")
        hit = gone & {i for row in ids for i in row}
        assert not hit, sorted(hit)[:5]
        searches += 1
    t.join(120)
    assert not t.is_alive() and errors == [] and searches > 0


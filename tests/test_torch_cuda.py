"""PyTorch port on the card: the CUDA TAAT and flash-attention kernels
against their plain PyTorch versions. Marked ``cuda``; each test skips where
no card is present (decided inside the test, so every pytest worker collects
the same tests). This file imports nothing of JAX, so it also runs where JAX
is absent:

    pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: TAAT exact (integer weights, sums below 2^24). Flash attention,
at the non-pad positions, bf16 in and out on both sides: the kernel rounds
its unnormalised probabilities to bf16 and divides at the end, the plain
version normalises in f32 and then rounds, and each output is rounded to
bf16 (unit roundoff 2^-8). So each element lies within
``2^-7 * (|ref| + sum_s p_s |v_s|)`` of the plain one (the sum is the plain
version run on ``|v|``), and the mean abs err, which rounding keeps far
below that worst case (1.1e-4 against a mean ``|ref|`` of about 0.045 at
the served shape on an H100), stays under ``2^-7 * mean |ref|``.
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
@pytest.mark.parametrize("shape", [(50, 2048, 8, 12), (300, 4104, 3, 300),
                                   (7, 8, 1, 2)])
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


def _assert_flash_close(got, q, k, v, mask):
    ref = FA.flash_causal_attention_plain(q, k, v, mask).float()
    ref_abs = FA.flash_causal_attention_plain(q, k, v.abs(), mask).float()
    real = mask.bool()
    assert torch.isfinite(got.float()).all()
    diff = (got.float() - ref).abs()[real]
    ref, ref_abs = ref.abs()[real], ref_abs[real]
    assert bool((diff <= FLASH_RTOL * (ref + ref_abs)).all())
    assert float(diff.mean()) <= FLASH_RTOL * float(ref.mean())


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

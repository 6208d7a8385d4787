"""PyTorch port on the card: the CUDA TAAT kernel against its plain PyTorch
version. Marked ``cuda``; each test skips where no card is present (decided
inside the test, so every pytest worker collects the same tests). This file
imports nothing of JAX, so it also runs where JAX is absent:

    pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: exact (integer weights, sums below 2^24).
"""

import numpy as np
import pytest
import torch

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

"""PyTorch port, TAAT kernel module: the plain version against the JAX
package's Pallas kernel (interpret mode) and its matmul backend.

Tolerance: exact. Every impact weight and query weight is an integer and
every sum stays below 2^24, so f32 accumulation is exact in any order and
the three computations must agree bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mllm_sparse_retrieval_tpu.ops import impact_kernel as jax_kernel
from mllm_sparse_retrieval_tpu.ops.score_programs import (
    _scores_from_matrix as jax_scores_from_matrix)
from mllm_sparse_retrieval_tpu_torch.ops import impact_kernel as K
from mllm_sparse_retrieval_tpu_torch.ops import score_programs as SP


def _inputs(seed, t, n, b, q, dtype):
    rng = np.random.default_rng(seed)
    matrix = np.zeros((t + 1, n), np.float32)
    matrix[1:] = rng.integers(0, 350, size=(t, n))
    q_idx = rng.integers(0, t, size=(b, q)).astype(np.int32)
    q_idx[:, 1] = q_idx[:, 0]            # duplicate terms add
    q_w = rng.integers(-20, 300, size=(b, q)).astype(np.float32)
    q_w[:, -3:] = 0.0                    # padding slots
    return matrix.astype(dtype), q_idx, q_w


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_plain_matches_pallas_interpret(dtype):
    matrix, q_idx, q_w = _inputs(0, 40, 2048, jax_kernel.QUERY_TILE * 2, 10,
                                 dtype)
    safe_idx, safe_w = jax_kernel.prepare_query_arrays(q_idx, q_w)
    ref = np.asarray(jax_kernel.impact_scores_taat(
        jnp.asarray(matrix), jnp.asarray(safe_idx), jnp.asarray(safe_w),
        interpret=True))
    got = K.impact_scores_taat_plain(torch.from_numpy(matrix),
                                     torch.from_numpy(safe_idx),
                                     torch.from_numpy(safe_w))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_wrapper_on_cpu_matches_jax_matmul_backend(dtype):
    matrix, q_idx, q_w = _inputs(1, 60, 1024, 12, 16, dtype)
    ref = np.asarray(jax_scores_from_matrix(
        jnp.asarray(matrix.astype(np.float32)), jnp.asarray(q_idx),
        jnp.asarray(q_w)))
    got = SP._taat_scores(torch.from_numpy(matrix), torch.from_numpy(q_idx),
                          torch.from_numpy(q_w))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_port_matmul_backend_matches_jax():
    matrix, q_idx, q_w = _inputs(2, 60, 1024, 12, 16, np.float32)
    ref = np.asarray(jax_scores_from_matrix(
        jnp.asarray(matrix), jnp.asarray(q_idx), jnp.asarray(q_w)))
    got = SP._scores_from_matrix(torch.from_numpy(matrix),
                                 torch.from_numpy(q_idx),
                                 torch.from_numpy(q_w))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_prepare_query_arrays_matches_jax():
    _, q_idx, q_w = _inputs(3, 30, 8, 5, 9, np.float32)
    for a, b in zip(K.prepare_query_arrays(q_idx, q_w),
                    jax_kernel.prepare_query_arrays(q_idx, q_w)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_duplicate_terms_and_dead_row():
    matrix = torch.zeros((3, 16), dtype=torch.int16)
    matrix[1] = 2
    matrix[2] = 5
    q_idx = torch.tensor([[1, 1, 2, 0]], dtype=torch.int32)
    q_w = torch.tensor([[3.0, 4.0, 1.0, 0.0]])
    got = K.impact_scores_taat(matrix, q_idx, q_w)
    assert torch.equal(got, torch.full((1, 16), (3 + 4) * 2.0 + 5.0))


@pytest.mark.parametrize("bad", ["matrix_dtype", "idx_dtype", "w_dtype",
                                 "shape", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    matrix = torch.zeros((4, 16), dtype=torch.int16)
    q_idx = torch.zeros((2, 3), dtype=torch.int32)
    q_w = torch.zeros((2, 3), dtype=torch.float32)
    if bad == "matrix_dtype":
        matrix = matrix.to(torch.int32)
    elif bad == "idx_dtype":
        q_idx = q_idx.long()
    elif bad == "w_dtype":
        q_w = q_w.double()
    elif bad == "shape":
        q_w = q_w[:, :2]
    else:
        matrix = matrix.to("meta")
    with pytest.raises((TypeError, ValueError)):
        K.impact_scores_taat(matrix, q_idx, q_w)


def test_launch_count_does_not_move_on_cpu():
    K.reset_launch_count()
    matrix, q_idx, q_w = _inputs(4, 10, 16, 2, 4, np.int16)
    safe_idx, safe_w = K.prepare_query_arrays(q_idx, q_w)
    K.impact_scores_taat(torch.from_numpy(matrix), torch.from_numpy(safe_idx),
                         torch.from_numpy(safe_w))
    assert K.launch_count() == 0


@pytest.mark.parametrize("batch, n_cols, sms, want", [
    (8, 26624, 132, 4),        # the served text batch: 104 blocks at split 1
    (1, 8, 132, 8),            # one query, one tile: the largest split
    (1, 26624, 132, 8),
    (30, 26624, 132, 2),       # 390 blocks at split 1: just short of 396
    (31, 26624, 132, 1),       # 403 blocks
    (256, 26624, 132, 1),      # the bench batch fills the card unsplit
    (256, 26624, 4000, 4),     # a wider card needs more blocks
])
def test_taat_split_fills_the_card(batch, n_cols, sms, want):
    """The least term split whose blocks give every SM three, else the
    largest."""
    split = K.taat_split(batch, n_cols, sms)
    assert split == want and split in K.SPLITS
    blocks = batch * -(-n_cols // (K.BLOCK_COLS // split))
    assert blocks >= sms * K.FILL_BLOCKS_PER_SM or split == K.SPLITS[-1]
    if split > 1:
        fewer = batch * -(-n_cols // (K.BLOCK_COLS // (split // 2)))
        assert fewer < sms * K.FILL_BLOCKS_PER_SM


@pytest.mark.parametrize("setting", [True, False])
def test_matmul_backend_restores_the_tf32_switch(setting):
    """The matmul backend turns TF32 off only for its own matmul."""
    matrix, q_idx, q_w = _inputs(5, 30, 128, 3, 16, np.int16)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = setting
        with SP.full_f32_matmul():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        SP._scores_from_matrix(torch.from_numpy(matrix),
                               torch.from_numpy(q_idx),
                               torch.from_numpy(q_w))
        assert torch.backends.cuda.matmul.allow_tf32 is setting
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved

"""PyTorch and CUDA port of ``mllm_sparse_retrieval_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's subpackages and module names so each
counterpart is easy to find. It imports ``torch`` and numpy, never JAX, and
nothing of the JAX package. Entry points run on ``device="cuda"`` unless the
caller passes ``device="cpu"``; the one hand-written kernel of this slice,
term-at-a-time impact scoring, lives in ``ops/impact_kernel.py`` with its
CUDA source in ``csrc/taat.cu``.
"""

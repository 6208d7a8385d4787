"""PyTorch and CUDA port of ``mllm_sparse_retrieval_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's subpackages and module names so each
counterpart is easy to find. It imports ``torch`` and numpy, never JAX, and
nothing of the JAX package. Entry points run on ``device="cuda"`` unless the
caller passes ``device="cpu"``.

Four paths are ported: text-query serving and image-query serving
(``serving/``: ``RetrievalService`` with ``OnlineQueryEncoder``, on the
LLaVA-NeXT anyres image path), contrastive LoRA training
(``train/trainer.py``: ``ContrastiveTrainer``), and offline evaluation
(``data.CrossModalCorpus`` -> ``pipelines.encode.encode_examples`` ->
``write_artifacts`` -> ``index.ImpactIndex.from_jsonl`` (the native C++
builder in ``index/native``) and ``index.DenseFlatIndex`` ->
``search.engine.run_search`` -> host fusion and recall; the CLIs in
``cli/``). Their hand-written kernels
live in three CUDA sources, built with plain ``nvcc`` at first use
(``ops/cuda_build.py``): ``csrc/taat.cu``, term-at-a-time impact scoring
(``ops/impact_kernel.py``); ``csrc/flash_attn.cu``, the causal
flash-attention forward; and ``csrc/flash_attn_bwd.cu``, its dq and dkv
backward kernels (both in ``ops/flash_attention.py``).
"""

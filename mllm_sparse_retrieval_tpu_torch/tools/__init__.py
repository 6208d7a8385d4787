"""End-to-end runbooks and measuring tools of the port. The runbooks, each
a command of its own:

- ``python -m mllm_sparse_retrieval_tpu_torch.tools.reproduce_recall``: a
  converted checkpoint and a dataset to the recall table (t2i and i2t;
  dense, sparse and hybrid) with search-only QPS and index build times;
- ``python -m mllm_sparse_retrieval_tpu_torch.tools.train_retrieve_e2e``:
  few-shot contrastive LoRA training must lift recall@1 (exit 1 below
  ``--min-lift``);
- ``python -m mllm_sparse_retrieval_tpu_torch.tools.corpus_e2e``: the
  stack at Flickr30k-test scale with the tiny family, gated on id
  consistency, finite scores and captions retrieving themselves.

The measuring tools, each ``python -m mllm_sparse_retrieval_tpu_torch.
tools.<name>`` with the JAX tool's flags: ``serve_loadtest`` (served QPS
and latency, HTTP or in process, static or live), ``latency_profile``
(per-batch tail latency of the search stream), the interleaved A/B tools
``engine_ab``, ``hybrid_ab``, ``eval_ab``, ``live_ab``, ``dense_ab`` and
``ann_ab``, ``mxu_probe`` (the tensor-core probe of ``ops/mips.py``),
``scaling_report`` (bytes per device and transfers by sharding strategy)
and ``cache_probe`` (the kernel build cache).

Each takes ``--device`` (default ``cuda``: without a card it raises; pass
``--device cpu`` to run on the CPU) and ``main(argv=None)``, which returns
what it printed; the runbooks and ``serve_loadtest`` take ``model=``, a
built ``(params, arch, tokenizer, template)`` on that device.
"""

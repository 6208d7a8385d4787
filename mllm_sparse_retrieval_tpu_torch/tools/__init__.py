"""End-to-end runbooks over the whole port, each a command of its own:

- ``python -m mllm_sparse_retrieval_tpu_torch.tools.reproduce_recall``: a
  converted checkpoint and a dataset to the recall table (t2i and i2t;
  dense, sparse and hybrid) with search-only QPS and index build times;
- ``python -m mllm_sparse_retrieval_tpu_torch.tools.train_retrieve_e2e``:
  few-shot contrastive LoRA training must lift recall@1 (exit 1 below
  ``--min-lift``);
- ``python -m mllm_sparse_retrieval_tpu_torch.tools.corpus_e2e``: the
  stack at Flickr30k-test scale with the tiny family, gated on id
  consistency, finite scores and captions retrieving themselves.

Each takes ``--device`` (default ``cuda``: without a card it raises; pass
``--device cpu`` to run on the CPU) and ``main(argv=None, model=None)``,
``model`` a built ``(params, arch, tokenizer, template)`` on that device.
"""

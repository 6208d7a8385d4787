"""Command-line entry points of the offline evaluation path:

- ``python -m mllm_sparse_retrieval_tpu_torch.cli.encode``: corpus or
  queries -> dense pickles + sparse jsonl / query.tsv;
- ``python -m mllm_sparse_retrieval_tpu_torch.cli.index``: corpus jsonl ->
  impact index;
- ``python -m mllm_sparse_retrieval_tpu_torch.cli.search``: encode queries,
  search, fuse, print recall.

Each takes ``--device`` (default ``cuda``).
"""

"""Command-line entry points of the offline evaluation path and the
server:

- ``python -m mllm_sparse_retrieval_tpu_torch.cli.encode``: corpus or
  queries -> dense pickles + sparse jsonl / query.tsv;
- ``python -m mllm_sparse_retrieval_tpu_torch.cli.index``: corpus jsonl ->
  impact index;
- ``python -m mllm_sparse_retrieval_tpu_torch.cli.search``: encode queries,
  search, fuse, print recall;
- ``python -m mllm_sparse_retrieval_tpu_torch.cli.serve``: static or live
  indexes over HTTP;
- ``python -m mllm_sparse_retrieval_tpu_torch.cli.ingest``: encode a
  corpus and POST it into a live server.

Each takes ``--device`` (default ``cuda``).
"""

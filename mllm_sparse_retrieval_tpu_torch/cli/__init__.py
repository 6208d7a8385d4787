"""Command-line entry points of the offline evaluation path, the server,
training and its data preparation and analysis:

- ``python -m mllm_sparse_retrieval_tpu_torch.cli.encode``: corpus or
  queries -> dense pickles + sparse jsonl / query.tsv;
- ``python -m mllm_sparse_retrieval_tpu_torch.cli.index``: corpus jsonl ->
  impact index;
- ``python -m mllm_sparse_retrieval_tpu_torch.cli.search``: encode queries,
  search, fuse, print recall;
- ``python -m mllm_sparse_retrieval_tpu_torch.cli.serve``: static or live
  indexes over HTTP;
- ``python -m mllm_sparse_retrieval_tpu_torch.cli.ingest``: encode a
  corpus and POST it into a live server;
- ``python -m mllm_sparse_retrieval_tpu_torch.cli.prepare_data``: Karpathy
  JSON -> CSVs, few-shot subsets, the captions-per-image check;
- ``python -m mllm_sparse_retrieval_tpu_torch.cli.train``: few-shot
  contrastive LoRA training -> ``lora.pkl``;
- ``python -m mllm_sparse_retrieval_tpu_torch.cli.stats``: term-weight and
  fusion-provenance statistics.

Each but ``prepare_data`` takes ``--device`` (default ``cuda``).
"""

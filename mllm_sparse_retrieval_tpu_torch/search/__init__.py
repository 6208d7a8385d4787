"""Search layer: run dictionaries, host fusion, TREC run IO and the
``run_search`` engine."""

from mllm_sparse_retrieval_tpu_torch.search.fusion import (
    explain_fusion, fuse, fuse_rrf, fuse_statistic, read_trec_run,
    write_trec_run)
from mllm_sparse_retrieval_tpu_torch.search.runs import (
    ArrayRun, make_run, merge_runs)

__all__ = ["ArrayRun", "explain_fusion", "fuse", "fuse_rrf",
           "fuse_statistic", "make_run", "merge_runs", "read_trec_run",
           "write_trec_run"]

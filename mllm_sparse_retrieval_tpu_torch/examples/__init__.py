"""Demos of the port, each a command of its own:

- ``python -m mllm_sparse_retrieval_tpu_torch.examples.smoke``: one image
  and a few captions encoded, their cosine similarities and top sparse
  terms printed.
"""

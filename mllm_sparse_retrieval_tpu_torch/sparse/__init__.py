"""Sparse term selection (ids, weights, canonical collision map) and the
string-keyed artifact forms."""

from mllm_sparse_retrieval_tpu_torch.sparse.term_selection import (
    SelectedTerms, canonical_id_map, doc_string_vector, filter_token,
    get_filtered_ids, quantize_weights, query_string_weights,
    select_image_terms, select_text_terms, text_candidate_ids)

__all__ = ["SelectedTerms", "canonical_id_map", "doc_string_vector",
           "filter_token", "get_filtered_ids", "quantize_weights",
           "query_string_weights", "select_image_terms",
           "select_text_terms", "text_candidate_ids"]

"""Sparse term selection helpers (a copy of the JAX package's
``sparse/term_selection.py``, cut to what this slice uses).

Token ids are the primary key space. ``canonical_id_map`` reproduces the
string-keyed artifact path's collision merges (lowercase, leading-character
filter) on ids, so an id-keyed index scores exactly like a string-keyed one.
``doc_string_vector`` / ``query_string_weights`` build the string-keyed
forms themselves: the corpus jsonl and query.tsv artifacts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np

from mllm_sparse_retrieval_tpu_torch.data.tokenization import caption_words


@dataclass(frozen=True)
class SelectedTerms:
    """A sparse vector: parallel arrays of token ids and integer weights."""

    token_ids: np.ndarray   # int32 [k]
    weights: np.ndarray     # int32 [k], quantized round(w * scale)

    def __post_init__(self):
        if self.token_ids.shape != self.weights.shape:
            raise ValueError(f"token_ids {self.token_ids.shape} and weights "
                             f"{self.weights.shape} differ in shape")


def get_filtered_ids(vocab: Mapping[str, int]) -> np.ndarray:
    """Vocabulary ids eligible as expansion terms.

    A token qualifies if, after stripping one leading ``▁``/space, it is
    alphabetic or numeric and starts with a lowercase ASCII letter.
    Mirrors ``get_filtered_ids`` (reference src/encode.py:38-47).
    """
    ids = []
    for token, tid in vocab.items():
        if token and (token[0] == "▁" or token[0] == " "):
            token = token[1:]
        if not token:
            continue
        if not token.isalpha() and not token.isdigit():
            continue
        if "a" <= token[0] <= "z":
            ids.append(tid)
    return np.array(sorted(ids), dtype=np.int32)


def filter_token(token: str) -> str:
    """Strip one leading character when it is not in [a-z].

    Mirrors ``filter_token`` (reference src/encode.py:50-53). The
    reference indexes ``token[0]`` unconditionally; we guard the empty string.
    """
    if token and not ("a" <= token[0] <= "z"):
        token = token[1:]
    return token


def quantize_weights(values: np.ndarray, scale: float = 100.0) -> np.ndarray:
    """Quantize float weights to ints: round-half-to-even of ``v * scale``.

    Mirrors ``np.rint(values * 100).astype(int)``
    (reference src/encode.py:75,106,131).
    """
    return np.rint(np.asarray(values, dtype=np.float64) * scale).astype(np.int32)


def text_candidate_ids(
    text: str,
    encode_fn: Callable[[str], Sequence[int]],
) -> np.ndarray:
    """Candidate token ids of a caption: union of sub-token encodings of its
    stopword-filtered content words (reference src/encode.py:96-100).

    ``encode_fn`` tokenizes a single word *without* special tokens.
    Returned sorted ascending (the iteration order of a Python int set).
    """
    token_ids = set()
    for word in caption_words(text):
        token_ids.update(int(t) for t in encode_fn(word))
    return np.array(sorted(token_ids), dtype=np.int32)


def canonical_id_map(
    vocab: Mapping[str, int],
    is_filtered: bool,
    vocab_size: int = 0,
) -> np.ndarray:
    """Token id → canonical token id under the string collision rules.

    Two token ids are *string-colliding* when they lowercase (and, with
    ``is_filtered``, ``filter_token``) to the same string — e.g. "The"/"the".
    The string-keyed artifact path merges such ids implicitly through dict
    keys; the id-keyed fast path (``ImpactIndex.from_selected_terms`` /
    ``search_terms``) reproduces the exact same merge arithmetic by mapping
    every id to its class representative (the LOWEST colliding id) before
    keying. Slots not present in ``vocab`` map to -1 (dropped, mirroring
    ``_term_strings``'s out-of-vocab rule).

    One O(vocab) pass; build it once per (tokenizer, is_filtered) and reuse.
    """
    size = max(vocab_size, max(vocab.values(), default=-1) + 1)
    out = np.full(size, -1, np.int32)
    first: Dict[str, int] = {}
    for tid, tok in sorted((tid, tok) for tok, tid in vocab.items()):
        s = tok.lower()
        if is_filtered:
            s = filter_token(s)
        out[tid] = first.setdefault(s, tid)
    return out


# ---- string-keyed views (the corpus jsonl / query.tsv artifact forms) ----

def _term_strings(token_ids: np.ndarray, id_to_token: Mapping[int, str],
                  is_filtered: bool) -> List[Tuple[int, str]]:
    """Token ids -> lowercase (optionally ``filter_token``-ed) strings;
    ids outside ``id_to_token`` drop (a model can predict ids past the
    tokenizer's vocabulary)."""
    out = []
    for tid in token_ids.tolist():
        if tid not in id_to_token:
            continue
        tok = id_to_token[tid].lower()
        if is_filtered:
            tok = filter_token(tok)
        out.append((tid, tok))
    return out


def doc_string_vector(terms: SelectedTerms, id_to_token: Mapping[int, str],
                      is_filtered: bool) -> Dict[str, int]:
    """Document vector keyed by token string: ids that map to one string
    overwrite each other, last write wins (the reference's dict
    assembly)."""
    vec: Dict[str, int] = {}
    strings = dict(_term_strings(terms.token_ids, id_to_token, is_filtered))
    for tid, w in zip(terms.token_ids.tolist(), terms.weights.tolist()):
        if tid in strings:
            vec[strings[tid]] = int(w)
    return vec


def query_string_weights(terms: SelectedTerms,
                         id_to_token: Mapping[int, str],
                         is_filtered: bool) -> Dict[str, int]:
    """Query weights keyed by token string, colliding strings summed and
    non-positive weights dropped: the arithmetic of a query serialized as
    each token repeated weight-many times and counted back."""
    vec: Dict[str, int] = {}
    strings = dict(_term_strings(terms.token_ids, id_to_token, is_filtered))
    for tid, w in zip(terms.token_ids.tolist(), terms.weights.tolist()):
        if tid in strings and w > 0:
            vec[strings[tid]] = vec.get(strings[tid], 0) + int(w)
    return vec

"""PyTorch port, packing, term selection and the jax-free host copies
against the JAX package.

Tolerance: exact. Packing is a bit layout; selection runs on the same logits
on both sides and breaks ties toward the lower index on both; the host
modules are copies.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.configs import SparseConfig as JSparseConfig
from mllm_sparse_retrieval_tpu.data.tokenization import (
    caption_words as j_caption_words)
from mllm_sparse_retrieval_tpu.models.templates import LLAMA3 as J_LLAMA3
from mllm_sparse_retrieval_tpu.models.templates import TINY as J_TINY
from mllm_sparse_retrieval_tpu.models.tokenizer import (
    WordPieceLiteTokenizer as JTokenizer)
from mllm_sparse_retrieval_tpu.ops import packing as jpacking
from mllm_sparse_retrieval_tpu.ops import select as jselect
from mllm_sparse_retrieval_tpu.pipelines.encode import (
    resolve_text_ds_rows as j_resolve)
from mllm_sparse_retrieval_tpu.sparse import term_selection as jts
from mllm_sparse_retrieval_tpu_torch.configs import SparseConfig
from mllm_sparse_retrieval_tpu_torch.data.tokenization import caption_words
from mllm_sparse_retrieval_tpu_torch.models.templates import LLAMA3, TINY
from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
    WordPieceLiteTokenizer)
from mllm_sparse_retrieval_tpu_torch.ops import packing, select
from mllm_sparse_retrieval_tpu_torch.pipelines.encode import (
    resolve_text_ds_rows)
from mllm_sparse_retrieval_tpu_torch.sparse import term_selection as ts

WORDS = ("a dog runs in the park with a red ball while the man reads "
         "near an old stone bridge over the quiet river at dusk").split()


def _captions(seed, n=40, length=9):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=length)) + "." for _ in range(n)]


def test_pack_topk_round_trips_through_jax_unpacker():
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(5, 7)).astype(np.float32)
    scores[0, 0] = -np.inf
    scores[1, 1] = 1e-40                       # denormal bits survive
    idx = rng.integers(0, 2 ** 23, size=(5, 7)).astype(np.int32)
    packed = packing.pack_topk(torch.from_numpy(scores),
                               torch.from_numpy(idx)).numpy()
    ref = np.asarray(jpacking.pack_topk(jnp.asarray(scores),
                                        jnp.asarray(idx)))
    np.testing.assert_array_equal(packed, ref)
    s, i = jpacking.unpack_topk(packed)
    np.testing.assert_array_equal(s.view(np.int32), scores.view(np.int32))
    np.testing.assert_array_equal(i, idx)


def test_pack_blocks_round_trips_through_jax_unpacker():
    rng = np.random.default_rng(1)
    f = rng.normal(size=(4, 3)).astype(np.float32)
    i = rng.integers(-5, 5, size=(4, 2)).astype(np.int32)
    v = rng.integers(0, 9, size=(4,)).astype(np.int32)
    blocks = [(f, True), (i, False), (v, False)]
    packed = packing.pack_blocks(
        [(torch.from_numpy(a), fl) for a, fl in blocks]).numpy()
    ref = np.asarray(jpacking.pack_blocks(
        [(jnp.asarray(a), fl) for a, fl in blocks]))
    np.testing.assert_array_equal(packed, ref)
    spec = [(3, True), (2, False), (1, False)]
    for got, want in zip(jpacking.unpack_blocks(packed, spec),
                         packing.unpack_blocks(packed, spec)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        packing.unpack_blocks(packed, spec[:2])


def _logits_with_ties(seed, b=4, v=300):
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(size=(b, v)), 1).astype(np.float32)  # many ties
    return np.log1p(np.maximum(x, 0)).astype(np.float32)


def test_vocab_and_filtered_topk_match_jax():
    x = _logits_with_ties(2)
    vals, ids = select.vocab_topk(torch.from_numpy(x), 10)
    jv, ji = jselect.vocab_topk(jnp.asarray(x), 10)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    fm = np.random.default_rng(3).random(x.shape[1]) < 0.3
    vals, ids = select.filtered_topk(torch.from_numpy(x),
                                     torch.from_numpy(fm), 12)
    jv, ji = jselect.filtered_topk(jnp.asarray(x), jnp.asarray(fm), 12)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))


def test_candidate_topk_matches_jax():
    x = _logits_with_ties(4)
    rows = [np.sort(np.random.default_rng(s).choice(300, n, replace=False))
            for s, n in ((5, 3), (6, 0), (7, 70), (8, 12))]
    cand, mask = jselect.pad_candidates(rows)
    got = select.candidate_topk(torch.from_numpy(x), torch.from_numpy(cand),
                                torch.from_numpy(mask), 128)
    ref = jselect.candidate_topk(jnp.asarray(x), jnp.asarray(cand),
                                 jnp.asarray(mask), 128)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("cfg", [dict(), dict(num_expanded_tokens=5),
                                 dict(sparse_manual=True, sparse_length=8)])
def test_resolve_text_ds_rows_matches_jax(cfg):
    x = _logits_with_ties(9, b=4, v=300)
    rows = [np.sort(np.random.default_rng(s).choice(300, n, replace=False))
            for s, n in ((10, 6), (11, 0), (12, 20), (13, 1))]
    cand, mask = jselect.pad_candidates(rows)
    fm = np.random.default_rng(14).random(300) < 0.5
    fv, fi = select.vocab_topk(torch.from_numpy(x), 10)
    cv, ci, cnt = select.candidate_topk(torch.from_numpy(x),
                                        torch.from_numpy(cand),
                                        torch.from_numpy(mask), 128)
    parts = [fv.numpy(), fi.numpy(), cv.numpy(), ci.numpy(),
             cnt.numpy()[:, None]]
    if cfg.get("num_expanded_tokens"):
        ev, ei = select.filtered_topk(torch.from_numpy(x),
                                      torch.from_numpy(fm),
                                      cfg["num_expanded_tokens"] + 64)
        parts += [ev.numpy(), ei.numpy()]
    parts.append(np.zeros((4, 2), np.float32))   # dense block, ignored
    got = resolve_text_ds_rows(parts, 4, cand, mask, SparseConfig(**cfg))
    ref = j_resolve(parts, 4, cand, mask, JSparseConfig(**cfg))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.token_ids, r.token_ids)
        np.testing.assert_array_equal(g.weights, r.weights)


def test_host_copies_match_jax():
    caps = _captions(15)
    tok = WordPieceLiteTokenizer.from_corpus_captions(caps, vocab_size=200)
    jtok = JTokenizer.from_corpus_captions(caps, vocab_size=200)
    assert tok.get_vocab() == jtok.get_vocab()
    for c in caps[:5] + ["Don't stop: the DOG's ball!"]:
        assert caption_words(c) == j_caption_words(c)
        assert tok.encode(c) == jtok.encode(c)
        np.testing.assert_array_equal(
            ts.text_candidate_ids(c, lambda w: tok.encode(w, False)),
            jts.text_candidate_ids(c, lambda w: jtok.encode(w, False)))
    vocab = tok.get_vocab()
    np.testing.assert_array_equal(ts.get_filtered_ids(vocab),
                                  jts.get_filtered_ids(vocab))
    for filt in (True, False):
        np.testing.assert_array_equal(ts.canonical_id_map(vocab, filt, 256),
                                      jts.canonical_id_map(vocab, filt, 256))
    w = np.array([0.004999, 0.005, 0.015, 1.2345, 3.0], np.float32)
    np.testing.assert_array_equal(ts.quantize_weights(w),
                                  jts.quantize_weights(w))
    ids, mask = tok.pad_batch([[1, 2, 3], [4]], max_len=5)
    jids, jmask = jtok.pad_batch([[1, 2, 3], [4]], max_len=5)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    for t, jt in ((LLAMA3, J_LLAMA3), (TINY, J_TINY)):
        assert t.fill_text(t.text_prompt(), "x") == \
            jt.fill_text(jt.text_prompt(), "x")

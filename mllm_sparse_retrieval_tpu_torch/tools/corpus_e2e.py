"""Full-corpus system check: the whole pipeline at real dataset scale.

Runs the whole stack (encode every Flickr30k-test caption, 5,000 in mode
'full'; build dense and impact indexes; search image queries against the
caption corpus, dense, sparse and fused; recall@k) with the tiny model on
seeded pixels. Recall is near random; what this checks is the SYSTEM at
true corpus scale: fixed-shape batching, the id-keyed and string impact
paths, index builds, both search engines, memory.

    python -m mllm_sparse_retrieval_tpu_torch.tools.corpus_e2e \\
        [--data-root DATA] [--limit-captions N] \\
        [--batch-size B] [--device cuda]

Prints per-phase timings and the recall table; exits 1 on any pipeline
inconsistency: ids that do not match the encoded rows or the queries,
non-finite dense vectors, the id-keyed index scoring other than the string
one, or captions queried against the caption corpus not finding
themselves at rank 1.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from mllm_sparse_retrieval_tpu_torch.configs import (ModelConfig, ModelFamily,
                                                     SearchConfig,
                                                     SparseConfig)
from mllm_sparse_retrieval_tpu_torch.data import CrossModalCorpus
from mllm_sparse_retrieval_tpu_torch.index.dense import DenseFlatIndex
from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex
from mllm_sparse_retrieval_tpu_torch.models.api import text_hidden_size
from mllm_sparse_retrieval_tpu_torch.models.registry import build_model
from mllm_sparse_retrieval_tpu_torch.pipelines.encode import encode_examples
from mllm_sparse_retrieval_tpu_torch.search.engine import run_search
from mllm_sparse_retrieval_tpu_torch.sparse import (canonical_id_map,
                                                    query_string_weights)
from mllm_sparse_retrieval_tpu_torch.tools.common import checked_device


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", flush=True)
    return 1


def main(argv=None, model=None):
    """Run the check; ``model`` is the tiny family's ``(params, arch,
    tokenizer, template)`` on ``--device``, else it is drawn from seed 0.
    Returns the exit code: 0, or 1 at the first failed gate."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-root", default="/root/reference/data",
                    help="the directory holding flickr/flickr_test.csv")
    ap.add_argument("--limit-captions", type=int, default=0,
                    help="0 = full corpus")
    ap.add_argument("--limit-queries", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda needs a card")
    args = ap.parse_args(argv)
    device = checked_device(args.device)

    t_start = time.time()
    corpus = CrossModalCorpus("flickr", "test", args.data_root)
    captions = corpus.examples("full")
    images = corpus.examples("single")
    if args.limit_captions:
        captions = captions[:args.limit_captions]
    print(f"corpus: {len(captions)} captions, {len(images)} images "
          f"(device={device})", flush=True)

    if model is None:
        cfg = ModelConfig(family=ModelFamily.TINY_DEBUG, dtype="float32",
                          tiny_vocab_size=2048, tiny_hidden_size=128)
        model = build_model(cfg, captions=[e.text for e in captions],
                            device=device)
    params, arch, tok, tmpl = model
    sp = SparseConfig()

    t0 = time.time()
    enc = encode_examples(captions, params, arch, tok, tmpl,
                          encode_type="text", sparse_cfg=sp,
                          batch_size=args.batch_size, device=device)
    n = len(captions)
    rate = n / (time.time() - t0)
    print(f"caption encode: {time.time() - t0:.1f}s "
          f"({rate:.0f} captions/s)", flush=True)
    want = (n, text_hidden_size(arch))
    if enc.dense.shape != want or len(enc.ids) != n or \
            len(enc.selected_terms) != n:
        return _fail(f"{n} captions encoded to dense {enc.dense.shape} "
                     f"(want {want}), {len(enc.ids)} ids and "
                     f"{len(enc.selected_terms)} term rows")
    if enc.ids != [e.text_id for e in captions]:
        return _fail("the encoded ids are not the captions' ids in order")
    if not np.isfinite(enc.dense).all():
        return _fail("non-finite dense vectors")

    t0 = time.time()
    dense = DenseFlatIndex(device=device)
    dense.add(enc.dense, enc.ids)
    # the product path: an id-keyed index straight from the selected terms
    cmap = canonical_id_map(tok.get_vocab(), sp.is_filtered)
    imp = ImpactIndex.from_selected_terms(enc.ids, enc.selected_terms, cmap,
                                          device=device)
    if not imp.int_keyed:
        return _fail("the impact index built from selected terms is not "
                     "id-keyed")
    print(f"index build (id-keyed): {time.time() - t0:.1f}s "
          f"({imp.num_docs} docs, {imp.num_terms} terms)", flush=True)

    # cross-check: the Lucene-parity string path scores identically
    t0 = time.time()
    imp_str = ImpactIndex(device=device)
    for i, v in zip(enc.ids, enc.sparse_vectors):
        imp_str.add(i, v)
    imp_str.finalize()
    probe = enc.selected_terms[:64]
    probe_dicts = [query_string_weights(t, enc.id_to_token, sp.is_filtered)
                   for t in probe]
    fs, fi = imp.search_terms(probe, 20, canonical_map=cmap)
    ss, si = imp_str.search(probe_dicts, 20)
    for q, (a_s, a_i, b_s, b_i) in enumerate(zip(fs, fi, ss, si)):
        if sorted(zip(a_s, a_i)) != sorted(zip(b_s, b_i)):
            return _fail(f"probe {q}: the id fast path diverged from the "
                         f"string path")
    del imp_str
    print(f"id-keyed vs string-path parity OK ({time.time() - t0:.1f}s)",
          flush=True)

    # i2t: images query the caption corpus (the reference's main direction)
    t0 = time.time()
    queries = images[:args.limit_queries]
    out = run_search(queries, params, arch, tok, tmpl, query_type="image",
                     sparse_cfg=sp,
                     search_cfg=SearchConfig(depth=100, alpha=0.5),
                     dense_index=dense, impact_index=imp,
                     batch_size=args.batch_size,
                     get_target=lambda qid: corpus.get_target(qid, "image"),
                     device=device)
    print(f"i2t search ({len(queries)} queries): {time.time() - t0:.1f}s",
          flush=True)
    print(out.summary(), flush=True)
    if len(out.dense_run) != len(queries) or \
            len(out.sparse_run) != len(queries):
        return _fail(f"{len(queries)} queries gave {len(out.dense_run)} "
                     f"dense and {len(out.sparse_run)} sparse run rows")

    # caption self-retrieval: a caption queried against the caption corpus
    # hits itself at rank 1 (dense cosine 1.0 with itself)
    t0 = time.time()
    self_q = captions[:32]
    out2 = run_search(self_q, params, arch, tok, tmpl, query_type="text",
                      sparse_cfg=sp, search_cfg=SearchConfig(depth=10),
                      dense_index=dense, batch_size=args.batch_size,
                      get_target=lambda qid: qid, device=device)
    r1 = out2.dense_recall[1]
    print(f"caption self-retrieval r@1 = {r1:.3f} "
          f"({time.time() - t0:.1f}s)", flush=True)
    if r1 < 0.95:
        return _fail(f"self-retrieval broken: r@1={r1}")

    print(f"CORPUS E2E OK in {time.time() - t_start:.0f}s total", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Ingest a corpus into a running live retrieval server (the JAX package's
``cli/ingest.py``).

Encode documents with the model on this process's device and POST them to
a ``cli.serve --live`` / ``--live-empty`` server, which keeps serving while
the corpus grows.

    # terminal 1: an empty live hybrid server
    python -m mllm_sparse_retrieval_tpu_torch.cli.serve --live-empty hybrid

    # terminal 2: stream the Flickr image corpus into it
    python -m mllm_sparse_retrieval_tpu_torch.cli.ingest \\
        --dataset flickr --family tiny_debug \\
        --server http://127.0.0.1:8080 --encode-type image

Sparse terms ship in the raw token-id key space (the live server's
default): queries encoded by the same family (the server's
``--encode-queries`` path, or this module's ``--query-smoke``) live in the
same space. Dense vectors ship as f32 JSON. The model runs on ``--device``
(default cuda).
"""

from __future__ import annotations

import argparse
import json
import urllib.request

from mllm_sparse_retrieval_tpu_torch.cli.common import (
    add_common_args, build_everything, get_logger, sparse_config_from_args)
from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc
from mllm_sparse_retrieval_tpu_torch.pipelines.encode import encode_examples


def _doc_payload(result, start: int, count: int, send_dense: bool,
                 send_terms: bool):
    """EncodeResult rows -> (``/documents`` JSON entries, skipped ids).
    Term ids merge by sum over duplicate slots (``ImpactIndex.add``'s dict
    semantics). Docs whose every sparse weight is zero are skipped when the
    server needs terms: one degenerate doc must not fail (400) the whole
    batch."""
    docs = []
    skipped = []
    for j in range(start, start + count):
        doc = {"id": result.ids[j]}
        if send_dense:
            doc["dense"] = [float(x) for x in result.dense[j]]
        if send_terms:
            st = result.selected_terms[j]
            terms = {}
            for t, w in zip(st.token_ids.tolist(), st.weights.tolist()):
                if w > 0:
                    terms[str(int(t))] = terms.get(str(int(t)), 0.0) \
                        + float(w)
            if not terms:
                skipped.append(result.ids[j])
                continue
            doc["terms"] = terms
        docs.append(doc)
    return docs, skipped


def _post(server: str, path: str, payload: dict, timeout: float = 300.0):
    req = urllib.request.Request(
        server.rstrip("/") + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _query_payload(q, send_dense: bool, send_terms: bool) -> dict:
    """One encoded query row -> a ``/search`` query object at depth 10."""
    query = {"depth": 10}
    if send_dense:
        query["dense"] = [float(x) for x in q.dense[0]]
    if send_terms:
        st = q.selected_terms[0]
        query["terms"] = {
            str(int(t)): float(w)
            for t, w in zip(st.token_ids.tolist(), st.weights.tolist())
            if w > 0}
    return query


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--server", required=True,
                        help="live server base URL (cli.serve --live[-empty])")
    parser.add_argument("--encode-type", default="image",
                        choices=["image", "text"],
                        help="corpus side to encode (the reference corpus "
                             "is images for t2i retrieval)")
    parser.add_argument("--limit", type=int, default=0,
                        help="ingest only the first N docs (0 = all)")
    parser.add_argument("--post-batch", type=int, default=256,
                        help="documents per POST /documents call")
    parser.add_argument("--compact-after", action="store_true",
                        help="POST /compact when done")
    parser.add_argument("--save-after", action="store_true",
                        help="POST /save when done (server --live-state)")
    parser.add_argument("--query-smoke", action="store_true",
                        help="after ingest, re-encode the first doc as a "
                             "query and check that it retrieves itself")
    add_common_args(parser)
    args = parser.parse_args(argv)
    logger = get_logger("ingest")

    # which engines does the server run?
    with urllib.request.urlopen(args.server.rstrip("/") + "/healthz",
                                timeout=60) as resp:
        mode = json.loads(resp.read())["mode"]
    send_dense = mode in ("dense", "hybrid")
    send_terms = mode in ("sparse", "hybrid")
    logger.info("server mode=%s -> sending %s", mode,
                "+".join(n for n, s in (("dense", send_dense),
                                        ("terms", send_terms)) if s))

    corpus, params, arch, tok, template, lora = build_everything(args)
    examples = corpus.examples_single()
    if args.limit:
        examples = examples[: args.limit]
    sparse_cfg = sparse_config_from_args(args)

    def encode(part, batch_size, is_query):
        return encode_examples(
            part, params, arch, tok, template, encode_type=args.encode_type,
            sparse_cfg=sparse_cfg, reps_loc=RepsLoc(args.reps_loc),
            batch_size=batch_size, is_query=is_query, lora=lora,
            device=args.device)

    total = 0
    n_skipped = 0
    # encode in model-batch multiples, POST in --post-batch slices; the
    # server ingests while it serves
    chunk = max(args.post_batch, args.batch_size)
    for start in range(0, len(examples), chunk):
        result = encode(examples[start:start + chunk], args.batch_size,
                        False)
        for off in range(0, len(result.ids), args.post_batch):
            n = min(args.post_batch, len(result.ids) - off)
            docs, skipped = _doc_payload(result, off, n, send_dense,
                                         send_terms)
            if skipped:
                n_skipped += len(skipped)
                logger.warning("skipping %d all-zero-sparse docs "
                               "(first: %s)", len(skipped), skipped[0])
            if docs:
                out = _post(args.server, "/documents", {"documents": docs})
                total += out["added"]
        logger.info("ingested %d/%d", min(start + chunk, len(examples)),
                    len(examples))
    logger.info("done: %d documents added%s", total,
                f", {n_skipped} skipped (empty sparse)" if n_skipped else "")

    if args.compact_after:
        logger.info("compact: %s", _post(args.server, "/compact", {}))
    if args.save_after:
        logger.info("save: %s", _post(args.server, "/save", {}))

    if args.query_smoke and examples:
        q = encode(examples[:1], 1, True)
        rows = _post(args.server, "/search", {"queries": [
            _query_payload(q, send_dense, send_terms)]})["results"][0]
        top = rows[0][0] if rows else None
        logger.info("query smoke: doc %r -> top hit %r %s", q.ids[0], top,
                    "OK" if top == q.ids[0] else "(MISMATCH)")
        if top != q.ids[0]:
            raise SystemExit(1)
    return 0


if __name__ == "__main__":
    main()

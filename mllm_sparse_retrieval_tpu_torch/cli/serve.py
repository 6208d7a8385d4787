"""Serve prebuilt or live indexes over HTTP with micro-batched device calls
(the JAX package's ``cli/serve.py``, one device).

The online counterpart of ``cli/search.py``: load the same artifacts, then
take queries over HTTP and coalesce them into device-sized batches
(``serving/``). A warm-up batch per configured depth level runs every
search shape once before the first request.

    python -m mllm_sparse_retrieval_tpu_torch.cli.serve \\
        --sparse-index indexes/sparse --passage-reps indexes/dense \\
        --port 8080 --depths 10,100,1000

``--live`` wraps the artifacts in live indexes (``--live-impl arena``, the
default, or ``segments``) and enables ``POST /documents``,
``/documents/delete``, ``/compact`` and ``/save``; ``--live-empty MODE``
starts live with no corpus; ``--live-state DIR`` resumes from a save there
and saves to it on shutdown (Ctrl-C or SIGTERM). ``--encode-queries``
loads the model and accepts ``{"text": ...}`` queries. The indexes and the
model live on ``--device`` (default cuda). ``boot`` builds the service and
the bound server around an encoder the caller already holds. Not ported:
``--mesh`` (ROADMAP Queue 1 #9).
"""

from __future__ import annotations

import argparse
import json
import os
import signal

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.cli.common import (
    add_common_args, build_everything, get_logger, sparse_config_from_args)
from mllm_sparse_retrieval_tpu_torch.configs import RepsLoc
from mllm_sparse_retrieval_tpu_torch.index.ann import DenseANNIndex
from mllm_sparse_retrieval_tpu_torch.index.arena import (
    ArenaDenseIndex, ArenaImpactIndex)
from mllm_sparse_retrieval_tpu_torch.index.dense import DenseFlatIndex
from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex
from mllm_sparse_retrieval_tpu_torch.index.live import (
    LiveDenseIndex, LiveImpactIndex)
from mllm_sparse_retrieval_tpu_torch.serving import aio, http
from mllm_sparse_retrieval_tpu_torch.serving.encoder import (
    OnlineQueryEncoder)
from mllm_sparse_retrieval_tpu_torch.serving.service import (
    RetrievalService, load_live_state)

_DENSE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}


def _warm(service, logger) -> None:
    """One query per depth level, so the first real requests find every
    device matrix placed and every kernel built."""
    if service.live:
        counts = service.stats()
        if counts.get("sparse_docs", 0) + counts.get("dense_docs", 0) == 0:
            logger.info("live empty service: nothing to warm yet")
            return
    for depth in service.depth_levels:
        terms = None
        dense = None
        if service.impact_index is not None:
            idx = service.impact_index
            key_src = getattr(idx, "term_to_idx", None)
            if key_src is None:       # segments: the first segment's keys
                for seg in idx._snapshot():
                    if seg.index.num_docs:
                        key_src = seg.index.term_to_idx
                        break
            terms = {next(iter(key_src)): 1.0} if key_src else {}
        if service.dense_index is not None:
            dense = np.zeros(service.dense_index.dim, np.float32)
            dense[0] = 1.0
        service.search(terms=terms, dense=dense,
                       depth=min(depth, service.depth_levels[-1]),
                       timeout=None)
        logger.info("warmed depth=%d", depth)
    if service.query_encoder is not None:
        service.search(text="warm up", depth=service.depth_levels[0],
                       timeout=None)
        logger.info("warmed text encode")


def _load_static_artifacts(args, reps_path, sparse_path):
    """Load static index artifacts with ``args``' dtype and ANN flags: the
    one loader of the boot and of ``POST /reload``."""
    dense = impact = None
    if reps_path:
        dense = DenseFlatIndex.load(
            reps_path, dtype=_DENSE_DTYPES[args.dense_dtype],
            device=args.device)
        if args.ann_rank:
            dense = DenseANNIndex.from_flat(dense, rank=args.ann_rank,
                                            candidates=args.ann_candidates)
    if sparse_path:
        impact = ImpactIndex.load(sparse_path, device=args.device)
    return dense, impact


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--passage-reps", default=None,
                        help="dense corpus dir (corpus_*.pkl)")
    parser.add_argument("--sparse-index", default=None,
                        help="impact index dir")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080,
                        help="0 picks a free port (logged at start)")
    parser.add_argument("--alpha", type=float, default=0.5)
    parser.add_argument("--fusion-rule", default="minmax",
                        choices=["minmax", "rrf"],
                        help="hybrid fusion formula: minmax = the "
                             "reference's weighted min-max (fused on the "
                             "device for static indexes); rrf = Reciprocal "
                             "Rank Fusion (fused on the host)")
    parser.add_argument("--depths", default="10,100,1000",
                        help="comma-separated servable depth levels")
    parser.add_argument("--default-depth", type=int, default=10)
    parser.add_argument("--max-batch", type=int, default=256)
    parser.add_argument("--max-wait-ms", type=float, default=4.0)
    parser.add_argument("--impact-backend", default="auto",
                        choices=["auto", "taat", "matmul"])
    parser.add_argument("--impact-wire", default="i32",
                        choices=["i32", "compact48"])
    parser.add_argument("--dense-dtype", default="float32",
                        choices=["float32", "bfloat16", "int8"])
    parser.add_argument("--ann-rank", type=int, default=0,
                        help="the ANN dense tier (index/ann.py): low-rank "
                             "prefilter width; 0 = exact. Static artifacts "
                             "only")
    parser.add_argument("--ann-candidates", type=int, default=1024,
                        help="rescored candidates per query with --ann-rank")
    parser.add_argument("--live", action="store_true",
                        help="serve mutable indexes: wrap the loaded "
                             "artifacts in live indexes and enable POST "
                             "/documents, /documents/delete, /compact")
    parser.add_argument("--live-empty", default=None,
                        choices=["dense", "sparse", "hybrid"],
                        help="start a live service of this mode with an "
                             "empty corpus; documents arrive by POST "
                             "/documents")
    parser.add_argument("--live-state", default=None,
                        help="live-state directory: resume from it when it "
                             "holds a save (artifact args are then "
                             "ignored), save to it on shutdown and on POST "
                             "/save")
    parser.add_argument("--live-impl", default="arena",
                        choices=["arena", "segments"],
                        help="live index: 'arena' (in-place device writes "
                             "and a tombstone mask, index/arena.py) or "
                             "'segments' (delta segments and a host merge, "
                             "index/live.py). A resume keeps the saved kind")
    parser.add_argument("--live-term-keys", default=None,
                        choices=["int", "str"],
                        help="sparse term key space of an empty live corpus "
                             "(int = token ids, the default; str = strings)."
                             " Ignored once docs exist")
    parser.add_argument("--filters", default=None,
                        help="JSON file of named doc filters to register at "
                             "boot: {\"tenant-a\": [doc ids...], ...} "
                             "(static indexes; more by POST /filters)")
    parser.add_argument("--http-impl", default="aio",
                        choices=["aio", "threaded"],
                        help="HTTP front end: 'aio' (one event-loop thread, "
                             "keep-alive and pipelining, serving/aio.py) or "
                             "'threaded' (a thread per connection, "
                             "serving/http.py)")
    parser.add_argument("--no-warm", action="store_true",
                        help="skip the per-depth warm-up batch")
    parser.add_argument("--verbose", action="store_true",
                        help="log every HTTP request")
    parser.add_argument("--encode-queries", action="store_true",
                        help="load the model (family/checkpoint args) and "
                             "accept {'text': ...} queries")
    parser.add_argument("--max-text-len", type=int, default=64,
                        help="token budget of the text encode (longer "
                             "queries truncate)")
    add_common_args(parser)
    return parser


def _has_live_state(path) -> bool:
    return bool(path) and any(
        os.path.exists(os.path.join(path, sub, "live.json"))
        for sub in ("dense", "sparse"))


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and check the command line (``parser.error`` exits)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.passage_reps is None and args.sparse_index is None \
            and args.live_empty is None and args.live_state is None:
        parser.error("need --passage-reps and/or --sparse-index "
                     "(or --live-empty MODE / --live-state DIR)")
    if args.live_empty and (args.passage_reps or args.sparse_index):
        parser.error("--live-empty starts with no corpus; drop the "
                     "artifact args or use --live to wrap them")
    if args.ann_rank and (args.live or args.live_empty or args.live_state):
        parser.error("--ann-rank serves static artifacts only (a live "
                     "corpus would retrain the projection on every add)")
    if args.ann_rank and args.dense_dtype == "int8":
        parser.error("--ann-rank is incompatible with --dense-dtype int8 "
                     "(pick one approximation; bf16 composes with ANN)")
    if args.mesh:
        parser.error("--mesh is not ported (ROADMAP Queue 1 #9)")
    if args.live_state and not _has_live_state(args.live_state) \
            and args.passage_reps is None and args.sparse_index is None \
            and args.live_empty is None:
        parser.error(f"--live-state {args.live_state} holds no save yet; "
                     "give artifacts or --live-empty MODE for the first "
                     "boot")
    return args


def build_encoder(args) -> OnlineQueryEncoder:
    """The query encoder of ``--encode-queries`` on ``args.device``."""
    _, params, arch, tok, template, lora = build_everything(args)
    return OnlineQueryEncoder(
        params, arch, tok, template, sparse_config_from_args(args),
        reps_loc=RepsLoc(args.reps_loc), lora=lora,
        max_text_len=args.max_text_len, device=args.device)


def _load_indexes(args, logger, indexes=None):
    """(dense, impact) of the boot: ``indexes`` when given, else a resumed
    live state, the artifacts, or empty live indexes; wrapped live as the
    flags ask."""
    dense_index = impact_index = None
    live_resumed = False
    if indexes is not None:
        dense_index, impact_index = indexes
    # resume check first: with a save the artifact args are ignored
    elif _has_live_state(args.live_state):
        if args.passage_reps or args.sparse_index:
            logger.info("live state found at %s: artifact args ignored",
                        args.live_state)
        dense_index, impact_index = load_live_state(
            args.live_state,
            dense_dtype=None if args.dense_dtype == "float32"
            else _DENSE_DTYPES[args.dense_dtype],
            background_compaction=True, device=args.device)
        live_resumed = True
        logger.info(
            "resumed live state: dense=%s sparse=%s",
            "-" if dense_index is None
            else f"{dense_index.num_docs}d/{dense_index.num_segments}s",
            "-" if impact_index is None
            else f"{impact_index.num_docs}d/{impact_index.num_segments}s")
    elif args.passage_reps or args.sparse_index:
        dense_index, impact_index = _load_static_artifacts(
            args, args.passage_reps, args.sparse_index)
        if dense_index is not None:
            if args.ann_rank:
                logger.info("ANN tier: rank=%d candidates=%d",
                            args.ann_rank, args.ann_candidates)
            logger.info("dense index: %d vectors", dense_index.size)
        if impact_index is not None:
            logger.info("impact index: %d docs / %d terms",
                        impact_index.num_docs, impact_index.num_terms)
    live = bool(args.live or args.live_empty or args.live_state)
    if live and not live_resumed:
        dense_live, impact_live = (
            (ArenaDenseIndex, ArenaImpactIndex) if args.live_impl == "arena"
            else (LiveDenseIndex, LiveImpactIndex))
        want = args.live_empty or (
            "hybrid" if dense_index is not None and impact_index is not None
            else "dense" if dense_index is not None else "sparse")
        # background_compaction: segment merges run off the request
        # threads (arena compaction is inline and bounded by its capacity)
        if want in ("dense", "hybrid"):
            dense_index = dense_live(
                dense_index, background_compaction=True,
                dtype=_DENSE_DTYPES[args.dense_dtype], device=args.device)
        if want in ("sparse", "hybrid"):
            impact_index = impact_live(
                impact_index, term_keys=args.live_term_keys,
                background_compaction=True, device=args.device)
    if live:
        logger.info("live mode: corpus is mutable while serving "
                    "(POST /documents, /documents/delete, /compact, /save)")
    return dense_index, impact_index


def boot(args, encoder=None, logger=None, indexes=None):
    """Build the service of ``args`` around ``encoder`` (``None``: no text
    queries), warm it unless ``--no-warm``, and bind (not start) the HTTP
    server -> ``(service, server)``. ``indexes``: static ``(dense,
    impact)`` indexes (either may be None) to serve in place of the ones
    the artifact flags name, wrapped live as the flags ask. The caller
    runs ``server.serve_forever()`` and, at the end,
    ``server.server_close()`` and ``service.close()``."""
    logger = logger or get_logger("serve")
    dense_index, impact_index = _load_indexes(args, logger, indexes)
    filters = None
    if args.filters:
        with open(args.filters) as f:
            filters = json.load(f)
        logger.info("registering %d doc filters from %s", len(filters),
                    args.filters)
    service = RetrievalService(
        dense_index, impact_index, alpha=args.alpha,
        depth_levels=[int(d) for d in args.depths.split(",")],
        default_depth=args.default_depth, backend=args.impact_backend,
        wire=args.impact_wire, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, query_encoder=encoder,
        live_state_dir=args.live_state, filters=filters,
        fusion_rule=args.fusion_rule)
    try:
        if not args.no_warm:
            _warm(service, logger)
        reload_fn = None
        if not service.live:
            def reload_fn(body):
                """POST /reload loader: fresh artifacts with this server's
                dtype and ANN flags (the boot's loader); paths default to
                the boot's."""
                reps_path = body.get("passage_reps", args.passage_reps)
                sparse_path = body.get("sparse_index", args.sparse_index)
                if (reps_path is None) != (args.passage_reps is None) or \
                        (sparse_path is None) != (args.sparse_index is None):
                    raise ValueError("reload must keep the serving mode: "
                                     "give the same artifact kinds as at "
                                     "boot")
                d, s = _load_static_artifacts(args, reps_path, sparse_path)
                logger.info("reload: dense=%s sparse=%s",
                            "-" if d is None else d.size,
                            "-" if s is None else s.num_docs)
                return d, s
        make_server = (aio.make_server if args.http_impl == "aio"
                       else http.make_server)
        server = make_server(service, args.host, args.port,
                             verbose=args.verbose, reload_fn=reload_fn)
    except BaseException:
        service.close()
        raise
    logger.info("serving mode=%s on http://%s:%d", service.mode,
                *server.server_address[:2])
    return service, server


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def main(argv=None):
    args = parse_args(argv)
    logger = get_logger("serve")
    encoder = None
    if args.encode_queries:
        encoder = build_encoder(args)
        logger.info("query encoder: family=%s max_text_len=%d",
                    args.family, encoder.max_text_len)
    service, server = boot(args, encoder, logger)
    # SIGTERM ends the server like Ctrl-C: the live state is saved
    signal.signal(signal.SIGTERM, _interrupt)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        try:
            if args.live_state and service.live:
                logger.info("saving live state to %s",
                            service.save_live(args.live_state))
        finally:
            server.server_close()
            service.close()


if __name__ == "__main__":
    main()

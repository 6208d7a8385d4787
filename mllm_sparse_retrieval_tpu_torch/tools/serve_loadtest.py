"""Load test for the online serving stack (serving/ + cli/serve shape).

Builds a synthetic Zipf corpus (bench.py's headline shape: 25,010 docs of
128 terms over 20,000), stands up a ``RetrievalService``, optionally behind
the HTTP server, and fires concurrent single-query clients at it,
reporting achieved QPS, per-request latency percentiles and the
micro-batcher's mean batch size.

This measures the deployment path: request coalescing, depth
quantization, engine dispatch and (for http) the JSON and HTTP work: the
layers above the engines that a batch benchmark leaves out. Every request
is a host round trip; what the card does per micro-batch is microseconds
of the TAAT kernel (sparse) and one GEMM (dense), so the numbers are
mostly the host's.

    python -m mllm_sparse_retrieval_tpu_torch.tools.serve_loadtest \\
        --mode hybrid --transport http [--device cuda]
    python -m mllm_sparse_retrieval_tpu_torch.tools.serve_loadtest \\
        --smoke --device cpu

``--query-kind text`` serves raw captions of ``--data-root``'s Flickr test
split through the live encoder (the tiny family, or the model passed to
``main(model=...)``). ``main`` returns the printed JSON object, with the
rows of the first ``KEEP_ROWS`` queries under ``rows`` and the count of
answered queries under ``answered``.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

from mllm_sparse_retrieval_tpu_torch.tools.common import (
    checked_device, hardware, normal_rows, zipf_docs, zipf_p, zipf_queries)

KEEP_ROWS = 16


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_text_stack(args, device, model=None):
    """A model and indexes built from real Flickr captions: the full
    online stack for ``--query-kind text`` (live encode on the device).
    ``model`` is a built ``(params, arch, tokenizer, template)``; without
    it the tiny family is built from the captions."""
    from mllm_sparse_retrieval_tpu_torch.configs import (
        ModelConfig, ModelFamily, SparseConfig)
    from mllm_sparse_retrieval_tpu_torch.data import CrossModalCorpus
    from mllm_sparse_retrieval_tpu_torch.index import (
        DenseFlatIndex, ImpactIndex)
    from mllm_sparse_retrieval_tpu_torch.models import build_model
    from mllm_sparse_retrieval_tpu_torch.pipelines.encode import (
        encode_examples)
    from mllm_sparse_retrieval_tpu_torch.serving import OnlineQueryEncoder
    from mllm_sparse_retrieval_tpu_torch.sparse import canonical_id_map

    corpus = CrossModalCorpus("flickr", "test", args.data_root)
    caps = list(corpus.text_dict.values())
    if model is None:
        cfg = ModelConfig(family=ModelFamily.TINY_DEBUG, dtype="float32")
        model = build_model(cfg, captions=caps, device=device)
    params, arch, tok, template = model
    scfg = SparseConfig()
    examples = corpus.examples_full()[: args.docs]
    res = encode_examples(examples, params, arch, tok, template,
                          encode_type="text", sparse_cfg=scfg,
                          batch_size=64, device=device)
    cmap = canonical_id_map(tok.get_vocab(), scfg.is_filtered)
    impact = dense = None
    if args.mode in ("sparse", "hybrid"):
        impact = ImpactIndex.from_selected_terms(
            res.ids, res.selected_terms, canonical_map=cmap, device=device)
    if args.mode in ("dense", "hybrid"):
        dense = DenseFlatIndex(device=device)
        dense.add(res.dense, res.ids)
    encoder = OnlineQueryEncoder(params, arch, tok, template, scfg,
                                 device=device)
    texts = [ex.text for ex in examples]
    queries = [texts[i % len(texts)] for i in range(args.n_queries)]
    return impact, dense, encoder, queries


def build_indexes(args, device):
    from mllm_sparse_retrieval_tpu_torch.index import (
        DenseFlatIndex, ImpactIndex)

    rng = np.random.default_rng(0)
    p = zipf_p(args.terms)
    doc_terms, doc_weights = zipf_docs(rng, args.docs, args.terms,
                                       args.doc_k, p)
    impact = dense = None
    if args.mode in ("sparse", "hybrid"):
        impact = ImpactIndex.from_packed_arrays(
            doc_terms, doc_weights, term_keys=range(args.terms),
            device=device)
    if args.mode in ("dense", "hybrid"):
        dense = DenseFlatIndex(device=device)
        reps = normal_rows(rng, args.docs, args.dim)
        ids = (impact.doc_ids if impact is not None
               else [str(i) for i in range(args.docs)])
        dense.add(reps, list(ids))
    return impact, dense, p, rng


def make_queries(args, zipf_p, rng):
    q_terms, q_w = zipf_queries(rng, args.n_queries, args.terms, args.q_k,
                                zipf_p)
    terms = [dict(zip(row.tolist(), w.tolist()))
             for row, w in zip(q_terms, q_w)]
    denses = normal_rows(rng, args.n_queries, args.dim)
    return terms, denses


def _stop_writers(wctx) -> None:
    if wctx:
        wctx[1].set()
        for t in wctx[0]:
            t.join(timeout=30)


def run_inproc(service, args, terms, denses, texts=None, writer_start=None):
    lat, lock, rows_of = [], threading.Lock(), {}
    idx = iter(range(args.n_queries))

    def worker():
        while True:
            with lock:
                i = next(idx, None)
            if i is None:
                return
            kw = {"depth": args.depth, "timeout": 300}
            if texts is not None:
                kw["text"] = texts[i]
            else:
                if service.impact_index is not None:
                    kw["terms"] = terms[i]
                if service.dense_index is not None:
                    kw["dense"] = denses[i]
            t0 = time.perf_counter()
            rows = service.search(**kw)
            dt = time.perf_counter() - t0
            assert len(rows) <= args.depth
            with lock:
                lat.append(dt)
                if i < KEEP_ROWS:
                    rows_of[i] = [(d, float(s)) for d, s in rows]

    wctx = writer_start(None) if writer_start else None
    try:
        wall, lats = drive(worker, args, lat)
    finally:
        _stop_writers(wctx)
    return wall, lats, (wctx[2] if wctx else None), rows_of, len(lat)


def run_http(service, args, terms, denses, texts=None, writer_start=None):
    import http.client

    if args.http_impl == "aio":
        from mllm_sparse_retrieval_tpu_torch.serving.aio import make_server
    else:
        from mllm_sparse_retrieval_tpu_torch.serving.http import make_server

    server = make_server(service, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    lat, lock, rows_of, answered = [], threading.Lock(), {}, [0]
    idx = iter(range(0, args.n_queries, args.per_request))

    def worker():
        # one persistent HTTP/1.1 connection per client thread (the server
        # speaks keep-alive), so the test measures the service and not a
        # connection per request
        conn = http.client.HTTPConnection("127.0.0.1",
                                          server.server_address[1],
                                          timeout=300)
        try:
            while True:
                with lock:
                    s = next(idx, None)
                if s is None:
                    return
                qs = []
                for i in range(s, min(s + args.per_request,
                                      args.n_queries)):
                    q = {"depth": args.depth}
                    if texts is not None:
                        q["text"] = texts[i]
                    else:
                        if service.impact_index is not None:
                            q["terms"] = {str(k): w
                                          for k, w in terms[i].items()}
                        if service.dense_index is not None:
                            q["dense"] = denses[i].tolist()
                    qs.append(q)
                payload = json.dumps({"queries": qs}).encode()
                t0 = time.perf_counter()
                conn.request("POST", "/search", body=payload,
                             headers={"Content-Type": "application/json"})
                body = json.loads(conn.getresponse().read())
                dt = time.perf_counter() - t0
                assert len(body["results"]) == len(qs)
                with lock:
                    lat.append(dt)
                    answered[0] += len(qs)
                    for j, row in enumerate(body["results"]):
                        if s + j < KEEP_ROWS:
                            rows_of[s + j] = [(d, float(sc))
                                              for d, sc in row]
        finally:
            conn.close()

    wctx = writer_start(base) if writer_start else None
    try:
        wall, lats = drive(worker, args, lat)
    finally:
        _stop_writers(wctx)
        server.shutdown()
        server.server_close()
    return wall, lats, (wctx[2] if wctx else None), rows_of, answered[0]


def drive(worker, args, lat):
    threads = [threading.Thread(target=worker) for _ in range(args.clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    return wall, np.asarray(lat)


def start_writers(service, base_url, args, rng):
    """Concurrent document writers for ``--live``: each writer loops
    add-a-doc / delete-an-older-own-doc until the read load finishes
    (stop event), counting ops and write latency. Returns
    ``(threads, stop, counters)``."""
    import urllib.request

    stop = threading.Event()
    counters = {"writes": 0, "deletes": 0, "lat": []}
    lock = threading.Lock()

    # numpy Generators are not thread-safe: one independent stream per
    # writer (deterministic given the parent seed)
    streams = rng.spawn(args.writers)

    def payload(wid, n):
        w_rng = streams[wid]
        doc = {"id": f"w{wid}_{n}"}
        if service.impact_index is not None:
            picked = w_rng.choice(args.terms, size=min(8, args.terms),
                                  replace=False)
            doc["terms"] = {str(int(t)): float(w_rng.integers(1, 50))
                            for t in picked}
        if service.dense_index is not None:
            doc["dense"] = w_rng.normal(size=args.dim).astype(
                np.float32).tolist()
        return doc

    def post(url, body):
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=300).read()

    def writer(wid):
        n = 0
        while not stop.is_set():
            doc = payload(wid, n)
            t0 = time.perf_counter()
            if base_url is None:
                d2 = dict(doc)
                if "terms" in d2:
                    d2["terms"] = {int(k): v for k, v in d2["terms"].items()}
                service.add_documents([d2])
                if n >= 8:
                    service.delete_documents([f"w{wid}_{n - 8}"])
            else:
                post(base_url + "/documents", {"documents": [doc]})
                if n >= 8:
                    post(base_url + "/documents/delete",
                         {"ids": [f"w{wid}_{n - 8}"]})
            dt = time.perf_counter() - t0
            with lock:
                counters["writes"] += 1
                counters["deletes"] += 1 if n >= 8 else 0
                counters["lat"].append(dt)
            n += 1
            time.sleep(args.write_interval_ms / 1e3)

    threads = [threading.Thread(target=writer, args=(w,), daemon=True)
               for w in range(args.writers)]
    for t in threads:
        t.start()
    return threads, stop, counters


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", default="hybrid",
                   choices=["sparse", "dense", "hybrid"])
    p.add_argument("--transport", default="http",
                   choices=["http", "inproc"])
    p.add_argument("--docs", type=int, default=25_010)
    p.add_argument("--terms", type=int, default=20_000)
    p.add_argument("--doc-k", type=int, default=128)
    p.add_argument("--q-k", type=int, default=64)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--depth", type=int, default=10)
    p.add_argument("--depth-levels", default="10,100,1000")
    p.add_argument("--n-queries", type=int, default=16_384)
    p.add_argument("--clients", type=int, default=64)
    p.add_argument("--per-request", type=int, default=1,
                   help="queries per HTTP POST (http transport)")
    p.add_argument("--http-impl", default="aio",
                   choices=["aio", "threaded"],
                   help="HTTP front end (cli.serve --http-impl): aio = "
                        "event loop (default), threaded = stdlib "
                        "thread-per-connection")
    p.add_argument("--max-batch", type=int, default=1024)
    p.add_argument("--max-wait-ms", type=float, default=8.0)
    p.add_argument("--query-kind", default="array",
                   choices=["array", "text"],
                   help="array: pre-encoded terms/dense vectors (engine "
                        "stack only); text: raw captions through the live "
                        "model encoder (tiny family, real Flickr captions)")
    p.add_argument("--data-root", default="/root/reference/data",
                   help="dataset root of --query-kind text (flickr CSVs)")
    p.add_argument("--live", action="store_true",
                   help="wrap the corpus in the live (segments+tombstones) "
                        "layer and run concurrent document writers during "
                        "the read load — the mutate-while-serving mix")
    p.add_argument("--live-impl", default="arena",
                   choices=["arena", "segments"],
                   help="live-index design with --live (cli.serve default "
                        "is arena)")
    p.add_argument("--writers", type=int, default=4,
                   help="concurrent writer threads with --live")
    p.add_argument("--write-interval-ms", type=float, default=20.0,
                   help="pause between one writer's ops with --live")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda needs a card")
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes; seconds on the CPU")
    return p


def main(argv=None, model=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.smoke:
        args.docs, args.terms, args.doc_k, args.q_k = 512, 256, 16, 8
        args.dim, args.n_queries, args.clients = 16, 256, 8
        args.max_batch, args.depth_levels = 64, "10"
    if args.live and args.query_kind == "text":
        p.error("--live measures the array engine stack")
    device = checked_device(args.device)

    t0 = time.time()
    terms = denses = texts = encoder = None
    if args.query_kind == "text":
        impact, dense, encoder, texts = build_text_stack(args, device, model)
        args.docs = (impact.num_docs if impact is not None
                     else dense.size)
    else:
        impact, dense, zipf, rng = build_indexes(args, device)
        terms, denses = make_queries(args, zipf, rng)
    log(f"built mode={args.mode} kind={args.query_kind} corpus "
        f"docs={args.docs} in {time.time() - t0:.1f}s")

    from mllm_sparse_retrieval_tpu_torch.serving import RetrievalService
    if args.live:
        if args.live_impl == "arena":
            from mllm_sparse_retrieval_tpu_torch.index import (
                ArenaDenseIndex as DenseLive, ArenaImpactIndex as ImpactLive)
        else:
            from mllm_sparse_retrieval_tpu_torch.index import (
                LiveDenseIndex as DenseLive, LiveImpactIndex as ImpactLive)
        if impact is not None:
            impact = ImpactLive(impact, background_compaction=True)
        if dense is not None:
            dense = DenseLive(dense, background_compaction=True)
        log(f"live mode ({args.live_impl}): {args.writers} writers every "
            f"{args.write_interval_ms} ms during the read load")
    levels = [int(d) for d in args.depth_levels.split(",")]
    service = RetrievalService(
        dense, impact, depth_levels=levels,
        default_depth=min(args.depth, levels[0]),
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        query_encoder=encoder)

    # warm every depth level so the measured window holds no first use
    t0 = time.time()
    for d in levels:
        if texts is not None:
            service.search(text=texts[0], depth=d, timeout=None)
        else:
            service.search(terms=terms[0] if impact is not None else None,
                           dense=denses[0] if dense is not None else None,
                           depth=d, timeout=None)
    log(f"warm ({len(levels)} depth levels): {time.time() - t0:.1f}s")

    writer_start = None
    if args.live:
        w_rng = np.random.default_rng(7)
        writer_start = lambda base_url: start_writers(   # noqa: E731
            service, base_url, args, w_rng)
    runner = run_http if args.transport == "http" else run_inproc
    try:
        wall, lat, wcounters, rows_of, answered = runner(
            service, args, terms, denses, texts, writer_start=writer_start)
        stats = service.stats()
    finally:
        service.close()

    qps = args.n_queries / wall
    pct = {f"p{q}": round(float(np.percentile(lat, q)) * 1e3, 2)
           for q in (50, 95, 99)} if lat.size else {}
    result = {
        "tool": "serve_loadtest", "mode": args.mode,
        "query_kind": args.query_kind,
        "transport": args.transport,
        "http_impl": args.http_impl if args.transport == "http" else None,
        "docs": args.docs,
        "n_queries": args.n_queries, "clients": args.clients,
        "per_request": args.per_request, "depth": args.depth,
        "qps": round(qps, 1), "wall_s": round(wall, 2),
        "latency_ms": pct,
        "mean_batch_size": round(stats["mean_batch_size"], 1),
        "batches": int(stats["batches"]),
    }
    if wcounters is not None:
        wlat = np.asarray(wcounters["lat"])
        result["live"] = {
            "impl": args.live_impl,
            "writes": wcounters["writes"],
            "deletes": wcounters["deletes"],
            "writes_per_s": round(wcounters["writes"] / wall, 1),
            "write_p50_ms": round(float(np.percentile(wlat, 50)) * 1e3, 2)
            if wlat.size else None,
            "write_p99_ms": round(float(np.percentile(wlat, 99)) * 1e3, 2)
            if wlat.size else None,
            "segments": {k: v for k, v in stats.items()
                         if k.endswith("_segments")},
        }
    print(json.dumps(result), flush=True)
    log(f"hardware: {hardware(device)}")
    return dict(result, rows=rows_of, answered=answered)


if __name__ == "__main__":
    main()
    sys.exit(0)

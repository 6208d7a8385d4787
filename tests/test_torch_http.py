"""PyTorch port, the HTTP front ends (``serving/router.py``, ``aio.py``,
``http.py``) and the server CLIs (``cli/serve.py``, ``cli/ingest.py``)
against the JAX package's on the CPU.

- Every endpoint of both front ends: the same requests to a port server
  and to a JAX server over the same live (or static) indexes give the same
  status codes and JSON bodies. ``/search`` rows compare as sets of
  ``(doc_id, round(score, 4))`` (integer corpora: exact scores; ties make
  only the order free); ``/stats`` and ``/metrics`` compare every counter
  that does not depend on how the micro-batcher happened to coalesce.
- ``text`` queries over HTTP with the tiny family's encoders (one set of
  weights, carried across from JAX) give the JAX server's results up to
  ties at the cut.
- ``image_b64`` of bytes that are no image is a 400, as in the JAX
  package (the port's own decoder refuses it where Pillow does).
- ``cli.serve --device cpu --live`` as a subprocess: its port read from its
  log line, its results equal to an in-process arena service's after the
  same add and delete, and its ``--live-state`` saved when it is stopped;
  a restart with ``--live-state`` alone resumes it.
- ``cli.ingest`` encodes a seeded flickr CSV with the tiny family and posts
  it into a ``cli.serve --live-empty hybrid`` subprocess; its query smoke
  finds the first document first.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from mllm_sparse_retrieval_tpu.index import arena as jarena
from mllm_sparse_retrieval_tpu.serving import aio as jaio
from mllm_sparse_retrieval_tpu.serving import http as jhttp
from mllm_sparse_retrieval_tpu.serving import RetrievalService as JService
from mllm_sparse_retrieval_tpu_torch.cli import ingest as ingest_cli
from mllm_sparse_retrieval_tpu_torch.index import (
    ArenaDenseIndex, ArenaImpactIndex, DenseFlatIndex, ImpactIndex)
from mllm_sparse_retrieval_tpu_torch.serving import (
    RetrievalService, aio, http)
from mllm_sparse_retrieval_tpu_torch.serving.router import decode_image
from tests.test_torch_live_service import (
    DIM, SVC, _corpus, _row_set, _static_pair)
from tests.test_torch_service import (  # noqa: F401 — a fixture
    _assert_same_up_to_ties, slice_setup)

REPO = Path(__file__).resolve().parent.parent
FRONT_ENDS = {"aio": (jaio.make_server, aio.make_server),
              "threaded": (jhttp.make_server, http.make_server)}
BOOT_TIMEOUT_S = 120


def _request(base, method, path, body=None, timeout=60):
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, raw, ctype = resp.status, resp.read(), \
                resp.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        status, raw, ctype = e.code, e.read(), e.headers["Content-Type"]
    if ctype.startswith("application/json"):
        return status, json.loads(raw)
    return status, raw.decode()


def _serve(make_server, svc, reload_fn=None):
    server = make_server(svc, port=0, reload_fn=reload_fn)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, "http://127.0.0.1:%d" % server.server_address[1]


def _stop(server, thread, svc):
    server.shutdown()
    server.server_close()
    thread.join(30)
    svc.close()
    assert not thread.is_alive()


def _same_response(path, got, want):
    (gs, gb), (ws, wb) = got, want
    assert gs == ws, (path, gb, wb)
    if path == "/search" and gs == 200:
        assert [_row_set(r) for r in gb["results"]] == \
            [_row_set(r) for r in wb["results"]]
    elif path == "/stats":
        for key in ("items", "errors", "mode", "live", "dense_docs",
                    "sparse_docs", "dense_segments", "sparse_segments"):
            assert gb.get(key) == wb.get(key), key
    elif path == "/metrics":
        # the port's own series (queue waits, padding) come after the JAX
        # package's: present, then left out of the comparison
        own = re.compile(r"^.*retrieval_(queue_wait_seconds|encoded_"
                         r"(rows|tokens)_(real|launched)_total).*\n",
                         re.MULTILINE)
        assert "retrieval_queue_wait_seconds_count " in gb
        assert "retrieval_encoded_tokens_launched_total " in gb
        mask = re.compile(r"^(retrieval_(batches_total|mean_batch_size|"
                          r"batch_latency_seconds\S*)) .*$", re.MULTILINE)
        assert mask.sub(r"\1", own.sub("", gb)) == mask.sub(r"\1", wb)
    elif path == "/save":
        assert gb["ok"] and wb["ok"]
    else:
        assert gb == wb, path


def _live_requests(rng):
    q = [{"terms": {str(t): 2.0 for t in rng.choice(50, 5, replace=False)},
          "dense": [float(x) for x in rng.integers(-9, 10, DIM)],
          "depth": 100} for _ in range(3)]
    add = [{"id": f"w{i}", "dense": [float(i + 1)] * DIM,
            "terms": {"7": 9.0, str(40 + i): 3.0}} for i in range(3)]
    return [
        ("GET", "/healthz", None), ("GET", "/filters", None),
        ("POST", "/search", {"queries": q}), ("POST", "/search", q[0]),
        ("POST", "/search", {"queries": [{"terms": {"1": 1.0}}]}),
        ("POST", "/search", {"queries": [dict(q[0], depth=0)]}),
        ("POST", "/search", b"{not json"),
        ("POST", "/search", {"queries": [dict(q[0], filter="nope")]}),
        ("POST", "/documents", {"documents": add}),
        ("POST", "/search", {"queries": q}),
        ("POST", "/documents", {"documents": "nope"}),
        ("POST", "/documents", {}),
        ("POST", "/documents", {"documents": [{"id": "x", "dense": [1.0],
                                               "terms": {"1": 1}}]}),
        ("POST", "/documents/delete", {"ids": ["w1", "d4", "ghost"]}),
        ("POST", "/documents/delete", {"ids": "w0"}),
        ("POST", "/search", {"queries": q}),
        ("POST", "/compact", {}),
        ("POST", "/search", {"queries": q}),
        ("POST", "/reload", {}),
        ("POST", "/filters", {"name": "t", "ids": ["d1"]}),
        ("POST", "/unknown", {}), ("GET", "/unknown", None),
        ("PUT", "/search", b"{}"),
        ("GET", "/stats", None), ("GET", "/metrics", None),
    ]


@pytest.mark.parametrize("front_end", ["aio", "threaded"])
def test_live_endpoints_match_jax(tmp_path, front_end):
    jmake, make = FRONT_ENDS[front_end]
    rng, docs, reps = _corpus()
    (jd, js), (pd, ps) = _static_pair(docs, reps)
    jsvc = JService(jarena.ArenaDenseIndex(jd, doc_headroom=8),
                    jarena.ArenaImpactIndex(js, doc_headroom=8),
                    live_state_dir=str(tmp_path / "j"), **SVC)
    svc = RetrievalService(ArenaDenseIndex(pd, doc_headroom=8),
                           ArenaImpactIndex(ps, doc_headroom=8),
                           live_state_dir=str(tmp_path / "p"), **SVC)
    jserver, jthread, jbase = _serve(jmake, jsvc)
    server, thread, base = _serve(make, svc)
    try:
        for method, path, body in _live_requests(rng) + [
                ("POST", "/save", {}),
                ("POST", "/save", {"directory": str(tmp_path / "q")})]:
            if path == "/save" and body.get("directory"):
                jbody = {"directory": str(tmp_path / "jq")}
            else:
                jbody = body
            got = _request(base, method, path, body)
            want = _request(jbase, method, path, jbody)
            _same_response(path, got, want)
        for d in ("p", "q"):
            assert (tmp_path / d / "sparse" / "live.json").exists()
            assert (tmp_path / d / "dense" / "seg0.pkl").exists()
        status, body = _request(base, "POST", "/search", {"queries": [
            {"image_b64": "aGVsbG8="}]})
        assert status == 400 and "not a JPEG or PNG" in body["error"]
    finally:
        _stop(jserver, jthread, jsvc)
        _stop(server, thread, svc)


@pytest.mark.parametrize("front_end", ["aio", "threaded"])
def test_static_endpoints_reload_and_filters_match_jax(front_end):
    jmake, make = FRONT_ENDS[front_end]
    rng, docs, reps = _corpus()
    (jd, js), (pd, ps) = _static_pair(docs, reps)
    docs2 = {k: v for k, v in docs.items() if k != "d2"}
    reps2 = {k: v for k, v in reps.items() if k != "d2"}
    (jd2, js2), (pd2, ps2) = _static_pair(docs2, reps2)

    def loader(pair):
        def reload_fn(body):
            if body.get("fail"):
                raise RuntimeError("artifact load failed")
            return pair
        return reload_fn

    jsvc = JService(jd, js, **SVC)
    svc = RetrievalService(pd, ps, **SVC)
    jserver, jthread, jbase = _serve(jmake, jsvc, loader((jd2, js2)))
    server, thread, base = _serve(make, svc, loader((pd2, ps2)))
    q = {"terms": {"3": 2.0, "7": 1.0}, "dense": [1.0] * DIM, "depth": 100,
         "filter": "t"}
    try:
        for method, path, body in [
                ("POST", "/filters", {"name": "t",
                                      "ids": ["d1", "d2", "d9"]}),
                ("POST", "/filters", {"name": "u", "ids": "d1"}),
                ("POST", "/filters", {"ids": ["d1"]}),
                ("GET", "/filters", None),
                ("POST", "/search", {"queries": [q]}),
                ("POST", "/documents", {"documents": []}),
                ("POST", "/compact", {}),
                ("POST", "/reload", {}),
                ("POST", "/search", {"queries": [q]}),
                ("POST", "/reload", {"fail": True}),
                ("GET", "/stats", None), ("GET", "/metrics", None)]:
            _same_response(path, _request(base, method, path, body),
                           _request(jbase, method, path, body))
    finally:
        _stop(jserver, jthread, jsvc)
        _stop(server, thread, svc)


@pytest.mark.parametrize("front_end", ["aio", "threaded"])
def test_text_queries_over_http_match_jax(slice_setup, front_end):
    """``{"text": ...}`` queries through both packages' live arena services
    (tiny_debug encoders with one set of weights) over HTTP: the same
    results up to ties at the cut."""
    jmake, make = FRONT_ENDS[front_end]
    jenc, enc, jindex, index, queries = slice_setup
    kw = dict(depth_levels=(10,), max_batch=8, max_wait_ms=5.0)
    jsvc = JService(impact_index=jarena.ArenaImpactIndex(jindex),
                    query_encoder=jenc, **kw)
    svc = RetrievalService(impact_index=ArenaImpactIndex(index),
                           query_encoder=enc, backend="taat", **kw)
    jserver, jthread, jbase = _serve(jmake, jsvc)
    server, thread, base = _serve(make, svc)
    try:
        body = {"queries": [{"text": q} for q in queries]}
        (gs, got), (ws, want) = (_request(b, "POST", "/search", body)
                                 for b in (base, jbase))
        assert gs == ws == 200
        for g, w in zip(got["results"], want["results"]):
            _assert_same_up_to_ties(g, w)
        assert sum(map(len, got["results"])) > 0
    finally:
        _stop(jserver, jthread, jsvc)
        _stop(server, thread, svc)


def test_decode_image_names_the_missing_decoder():
    assert decode_image(None) is None
    with pytest.raises(ValueError, match="image_b64: not a JPEG or PNG"):
        decode_image("aGVsbG8=")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


class _Server:
    """``cli.serve`` as a subprocess; its port comes from its log line."""

    def __init__(self, args, cwd):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "mllm_sparse_retrieval_tpu_torch.cli.serve",
             "--port", "0", "--device", "cpu", *args], cwd=cwd, env=_env(),
            stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True)
        self.log = []
        found = threading.Event()

        def read():
            for line in self.proc.stderr:
                self.log.append(line)
                if "serving mode=" in line:
                    found.set()

        self.reader = threading.Thread(target=read, daemon=True)
        self.reader.start()
        if not found.wait(BOOT_TIMEOUT_S):
            self.stop()
            pytest.fail("cli.serve never came up:\n" + "".join(self.log))
        port = re.search(r"http://[\d.]+:(\d+)", "".join(self.log)).group(1)
        self.base = f"http://127.0.0.1:{port}"

    def stop(self, sig=signal.SIGINT):
        if self.proc.poll() is None:
            self.proc.send_signal(sig)
            try:
                self.proc.wait(60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(10)
        self.reader.join(10)
        return self.proc.returncode


def test_cli_serve_subprocess_matches_in_process_arena(tmp_path):
    rng, docs, reps = _corpus()
    (_, _), (pd, ps) = _static_pair(docs, reps)
    ps.save(str(tmp_path / "sparse"))
    (tmp_path / "dense").mkdir()
    pd.save_shard(str(tmp_path / "dense" / "corpus_0.pkl"))
    (_, _), (pd2, ps2) = _static_pair(docs, reps)
    local = RetrievalService(ArenaDenseIndex(pd2), ArenaImpactIndex(ps2),
                             **{**SVC, "backend": "taat"})
    state = tmp_path / "state"
    srv = _Server(["--sparse-index", str(tmp_path / "sparse"),
                   "--passage-reps", str(tmp_path / "dense"), "--live",
                   "--live-state", str(state), "--depths", "10,100",
                   "--impact-backend", "taat", "--alpha", "0.3",
                   "--max-wait-ms", "2"], tmp_path)
    try:
        q = [{"terms": {str(t): 2.0 for t in rng.choice(50, 5,
                                                        replace=False)},
              "dense": [float(x) for x in rng.integers(-9, 10, DIM)],
              "depth": 100} for _ in range(3)]
        new = {"id": "new", "dense": [2.0] * DIM, "terms": {"7": 30.0}}
        for step in range(3):
            _, out = _request(srv.base, "POST", "/search", {"queries": q})
            for row, query in zip(out["results"], q):
                want = local.search(
                    terms={int(k): v for k, v in query["terms"].items()},
                    dense=query["dense"], depth=100)
                assert _row_set(row) == _row_set(want)
            if step == 0:
                assert _request(srv.base, "POST", "/documents",
                                {"documents": [new]}) == \
                    (200, {"added": 1})
                local.add_documents([dict(new, terms={7: 30.0})])
            elif step == 1:
                assert _request(srv.base, "POST", "/documents/delete",
                                {"ids": ["d5"]}) == (200, {"deleted": 1})
                local.delete_documents(["d5"])
    finally:
        local.close()
        rc = srv.stop()
    assert rc == 0, "".join(srv.log)
    manifest = json.loads((state / "sparse" / "live.json").read_text())
    assert manifest["kind"] == "impact-arena"
    saved = ImpactIndex.load(str(state / "sparse" / "seg0"), device="cpu")
    assert "new" in saved.doc_ids and "d5" not in saved.doc_ids
    # a restart with --live-state alone resumes the saved corpus
    back = _Server(["--live-state", str(state), "--depths", "100",
                    "--impact-backend", "taat"], tmp_path)
    try:
        _, out = _request(back.base, "GET", "/stats")
        assert out["live"] and out["sparse_docs"] == out["dense_docs"] == \
            len(docs)
        _, out = _request(back.base, "POST", "/search", {"queries": [
            {"terms": {"7": 1.0}, "dense": [2.0] * DIM, "depth": 100}]})
        served = {d for d, _ in out["results"][0]}
        assert "new" in served and "d5" not in served
    finally:
        assert back.stop() == 0, "".join(back.log)


def test_cli_ingest_into_a_live_empty_server(tmp_path):
    rng = np.random.default_rng(5)
    words = ["dog", "cat", "red", "bus", "man", "kite", "boat", "lake"]
    (tmp_path / "flickr").mkdir()
    lines = ["imgid,filename,caption,sentid"]
    for i in range(6):
        cap = "a " + " ".join(rng.choice(words, size=4))
        lines.append(f"{i},{i}.jpg,{cap},{100 + i}")
    (tmp_path / "flickr" / "flickr_test.csv").write_text(
        "\n".join(lines) + "\n")
    srv = _Server(["--live-empty", "hybrid", "--depths", "10",
                   "--impact-backend", "matmul", "--max-wait-ms", "2"],
                  tmp_path)
    try:
        rc = ingest_cli.main([
            "--server", srv.base, "--dataset", "flickr", "--data-root",
            str(tmp_path), "--family", "tiny_debug", "--dtype", "float32",
            "--device", "cpu", "--encode-type", "image", "--batch-size", "4",
            "--post-batch", "4", "--compact-after", "--query-smoke"])
        assert rc == 0
        _, st = _request(srv.base, "GET", "/stats")
        assert st["dense_docs"] == st["sparse_docs"] == 6
        assert st["dense_segments"] == st["sparse_segments"] == 1
        status, metrics = _request(srv.base, "GET", "/metrics")
        assert status == 200
        assert 'retrieval_live_docs{engine="sparse"} 6' in metrics
        assert 'retrieval_info{mode="hybrid",live="1"} 1' in metrics
    finally:
        # SIGTERM ends the server like Ctrl-C: exit 0
        assert srv.stop(signal.SIGTERM) == 0, "".join(srv.log)

"""PyTorch port, its tracing module (``mllm_sparse_retrieval_tpu_torch/
tracing.py``) and the spans and counters placed with it.

- With tracing off a span logs nothing and opens no profiler range.
- Under a CPU profiler a span is both a profiler range (``prof.events()``)
  and a log entry, their starts within 1 ms of each other on the
  profiler's absolute clock (``trace_start_ns()`` plus the event's
  relative start), parents nesting per thread.
- The micro-batcher gives every request one ``queue_wait`` span with its
  id, no shorter than the time the batcher was held, and ``/metrics``
  counts the same requests; each served batch is a ``micro_batch`` tally
  of its waits and counts, on or off, marked with whether tracing was on,
  its waits on the monotonic clock.
- ``encode_texts`` counts the real and launched rows and tokens of its
  fixed 32-row shape; ``encode_examples`` gives ``preprocess`` spans that
  count every image (or text) encoded and at least one ``prefetch_wait``;
  a training step is ``collate`` and then ``train_step`` around
  ``to_device``, ``forward``, ``backward`` and ``optimizer``.

No JAX here: the tiny models are drawn by the port's own registry.
"""

import re
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mllm_sparse_retrieval_tpu_torch import tracing
from mllm_sparse_retrieval_tpu_torch.configs import (
    ModelConfig, ModelFamily, SparseConfig, TrainConfig)
from mllm_sparse_retrieval_tpu_torch.data.karpathy import Example
from mllm_sparse_retrieval_tpu_torch.models import lora as lora_lib
from mllm_sparse_retrieval_tpu_torch.models.internvl import (
    InternViTConfig, InternVLConfig)
from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
from mllm_sparse_retrieval_tpu_torch.models.registry import (
    build_model, init_params)
from mllm_sparse_retrieval_tpu_torch.pipelines.encode import encode_examples
from mllm_sparse_retrieval_tpu_torch.serving.batcher import MicroBatcher
from mllm_sparse_retrieval_tpu_torch.serving.encoder import (
    OnlineQueryEncoder)
from mllm_sparse_retrieval_tpu_torch.serving.router import (
    prometheus_metrics)
from mllm_sparse_retrieval_tpu_torch.train.trainer import (
    ContrastiveTrainer, make_collator)
from tests.torch_threads import one_torch_thread  # noqa: F401

CAPTIONS = ["a dog runs on the beach", "two cats sit on a red sofa",
            "a man rides a bike down the hill", "children play in the park",
            "a plate of food on a wooden table", "a bird on a wire"]
TINY = ModelConfig(family=ModelFamily.TINY_DEBUG, dtype="float32",
                   tiny_vocab_size=512, tiny_hidden_size=64,
                   tiny_num_layers=2, tiny_num_heads=4, tiny_image_size=32,
                   tiny_patch_size=16)


@pytest.fixture(autouse=True)
def fresh_log():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


@pytest.fixture(scope="module")
def tiny():
    return build_model(TINY, captions=CAPTIONS, seed=0, device="cpu")


def _named(name):
    return [s for s in tracing.spans() if s.name == name]


def _no_range(monkeypatch):
    """Make any profiler range that ``tracing`` opens fail the test."""
    def refuse():
        raise AssertionError("a profiler range was opened")
    monkeypatch.setattr(tracing, "_range_ops", refuse)


# ---- the module ----------------------------------------------------------

def test_off_a_span_records_nothing_and_opens_no_range(monkeypatch):
    _no_range(monkeypatch)
    assert not tracing.on()
    with tracing.span("stage", rows=3):
        pass
    tracing.record("queue_wait", 1, 2, request=0)
    assert tracing.spans() == []


def test_on_without_a_profiler_logs_and_opens_no_range(monkeypatch):
    _no_range(monkeypatch)
    tracing.enable()
    with tracing.span("outer", batch=1, rows=4):
        with tracing.span("inner"):
            pass
    tracing.record("queue_wait", 10, 30, request=5, batch=1)
    inner, outer_rec, wait = tracing.spans()
    assert (inner.name, outer_rec.name, wait.name) == (
        "inner", "outer", "queue_wait")
    assert inner.parent == outer_rec.id and outer_rec.parent is None
    assert outer_rec.attrs == {"batch": 1, "rows": 4}
    assert (wait.start_ns, wait.end_ns, wait.parent) == (10, 30, None)
    assert wait.attrs == {"request": 5, "batch": 1}
    assert outer_rec.start_ns <= inner.start_ns <= inner.end_ns \
        <= outer_rec.end_ns
    tracing.clear()
    assert tracing.spans() == []


def test_under_a_profiler_a_span_is_a_range_and_a_log_entry():
    seen = {}

    def worker():
        with tracing.span("on_thread"):
            torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.on()
        with tracing.span("outer", rows=2):
            with tracing.span("inner"):
                torch.ones(8).sum()
            t = threading.Thread(target=worker, name="tracing-worker")
            t.start()
            t.join()
    assert not tracing.on()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    for evt in prof.events():
        if evt.name in ("outer", "inner"):
            seen[evt.name] = start_ns + evt.time_range.start * 1000
    log = {s.name: s for s in tracing.spans()}
    assert set(log) == {"outer", "inner", "on_thread"}
    assert set(seen) == {"outer", "inner"}
    for name, t0 in seen.items():
        assert abs(log[name].start_ns - t0) < 1_000_000, name
    assert log["inner"].parent == log["outer"].id
    assert log["on_thread"].parent is None           # its own thread's stack
    assert log["on_thread"].thread == "tracing-worker"
    assert log["outer"].attrs == {"rows": 2}


def test_counters_add_to_the_process_and_to_an_open_collect():
    """A count goes to the innermost ``collect`` open on its thread, and
    nowhere outside one; the block gives back the outer one."""
    outer, inner = {}, {}
    tracing.count("test_rows", 2)
    with tracing.collect(outer):
        tracing.count("test_rows", 3)
        with tracing.collect(inner):
            tracing.count("test_rows", 4)
            t = threading.Thread(target=tracing.count, args=("test_rows",))
            t.start()
            t.join()
        tracing.count("test_rows")
        tracing.count("test_tokens", 5)
    tracing.count("test_rows", 6)
    assert outer == {"test_rows": 4, "test_tokens": 5}
    assert inner == {"test_rows": 4}


def test_threads_lose_no_count_span_or_request():
    """More threads than cores, a short switch interval: every count, span
    and request id arrives once and each thread's parents nest on its own
    stack."""
    n_threads, per = 16, 300
    got = [dict() for _ in range(n_threads)]
    mb = MicroBatcher(lambda items: items, max_batch=8, max_wait_ms=0.5)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    tracing.enable()

    def work(k):
        with tracing.collect(got[k]):
            for _ in range(per):
                with tracing.span("outer", thread=k):
                    with tracing.span("inner"):
                        tracing.count("stress")
                        mb.submit(k)

    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        mb.close()
    assert all(g == {"stress": per} for g in got)
    log = tracing.spans()
    outer = {s.id: s for s in log if s.name == "outer"}
    inner = [s for s in log if s.name == "inner"]
    assert len(outer) == len(inner) == n_threads * per
    assert all(outer[s.parent].thread == s.thread for s in inner)
    waits = [s for s in log if s.name == "queue_wait"]
    assert sorted(s.attrs["request"] for s in waits) == \
        list(range(n_threads * per))
    assert mb.stats()["items"] == n_threads * per
    kept = tracing.tallies("micro_batch")
    assert len(kept) == mb.stats()["batches"]
    assert sum(len(t.values["waits_s"]) for t in kept) == n_threads * per


# ---- serving ---------------------------------------------------------------

class _Service:
    """What ``prometheus_metrics`` reads of a service, over a bare
    batcher."""
    mode, live = "sparse", False

    def __init__(self, batcher):
        self._batcher = batcher

    def stats(self):
        return self._batcher.stats()


def _metric(text, name):
    return float(re.search(rf"^{re.escape(name)} (\S+)$", text,
                           re.MULTILINE).group(1))


def test_batcher_gives_every_request_one_queue_wait():
    gate = threading.Event()

    def run(items):
        gate.wait(10)
        tracing.count("rows_real", len(items))
        return [x * 2 for x in items]

    tracing.enable()
    mb = MicroBatcher(run, max_batch=4, max_wait_ms=1.0)
    try:
        first = mb.submit(0)        # its batch holds the dispatcher
        time.sleep(0.05)
        futs = [mb.submit(i) for i in range(1, 7)]
        queued = time.time_ns()
        time.sleep(0.2)
        held_ns = time.time_ns() - queued
        gate.set()
        assert [f.result(10) for f in [first] + futs] == \
            [2 * i for i in range(7)]
    finally:
        mb.close()
    waits = _named("queue_wait")
    assert sorted(s.attrs["request"] for s in waits) == list(range(7))
    for s in waits:
        if s.attrs["request"] > 0:
            assert s.end_ns - s.start_ns >= held_ns
    runs = _named("run_batch")
    assert len(runs) == mb.stats()["batches"] == 3         # 1 + 4 + 2
    assert sorted(s.attrs["batch"] for s in runs) == [0, 1, 2]
    assert sum(s.attrs["rows"] for s in runs) == 7
    by_batch = {s.attrs["batch"]: s.attrs["rows"] for s in runs}
    for b, rows in by_batch.items():
        assert sum(1 for s in waits if s.attrs["batch"] == b) == rows
    text = prometheus_metrics(_Service(mb))
    assert _metric(text, "retrieval_requests_total") == 7
    assert _metric(text, "retrieval_queue_wait_seconds_count") == 7
    assert _metric(text, 'retrieval_queue_wait_seconds_bucket{le="+Inf"}') \
        == 7
    assert _metric(text, "retrieval_queue_wait_seconds_sum") >= \
        6 * held_ns / 1e9
    assert _metric(text, "retrieval_encoded_rows_real_total") == 7
    assert _metric(text, "retrieval_encoded_tokens_launched_total") == 0
    assert mb.counts() == {"rows_real": 7}
    kept = tracing.tallies("micro_batch")
    assert [t.traced for t in kept] == [True] * 3
    assert sorted(len(t.values["waits_s"]) for t in kept) == [1, 2, 4]
    assert sum(t.values["rows_real"] for t in kept) == 7
    assert sum(w for t in kept for w in t.values["waits_s"]) == \
        pytest.approx(_metric(text, "retrieval_queue_wait_seconds_sum"),
                      abs=1e-5)


def test_tallies_are_kept_off_and_the_window_is_the_last_untraced():
    """A batcher's tallies are kept with tracing off too; the readers'
    window is the last n of those, whatever ran traced after them."""
    from portbench import spanlog

    mb = MicroBatcher(lambda items: items, max_batch=2, max_wait_ms=0.5)
    try:
        for k in range(3):                         # off: 3 batches
            assert [f.result(10) for f in [mb.submit(k), mb.submit(k)]] \
                == [k, k]
        tracing.enable()
        mb.submit(9).result(10)                    # on: a traced batch
    finally:
        mb.close()
    assert tracing.spans() and len(_named("queue_wait")) == 1
    kept = tracing.tallies("micro_batch")
    assert [t.traced for t in kept][-1] is True
    untraced = [t for t in kept if not t.traced]
    assert sum(len(t.values["waits_s"]) for t in untraced) == 6
    window = spanlog.window(2, "micro_batch")
    assert window == [t.values for t in untraced][-2:]
    assert spanlog.window(0, "micro_batch") == []


def test_queue_waits_ignore_a_wall_clock_step(monkeypatch):
    """The histogram's waits are on the monotonic clock: a wall clock that
    steps back an hour mid-wait changes neither them nor the tally, and
    the log's span still ends after it starts."""
    gate = threading.Event()
    mb = MicroBatcher(lambda items: (gate.wait(10), items)[1], max_batch=4,
                      max_wait_ms=0.5)
    real = time.time_ns
    tracing.enable()
    try:
        first = mb.submit(0)
        time.sleep(0.05)
        later = mb.submit(1)
        monkeypatch.setattr(time, "time_ns",
                            lambda: real() - 3_600 * 10 ** 9)
        time.sleep(0.1)
        gate.set()
        assert (first.result(10), later.result(10)) == (0, 1)
    finally:
        mb.close()
    _, cum, total, count = mb.queue_wait_histogram()
    assert count == 2 and 0.05 <= total < 5.0
    assert all(0 <= w < 5.0 for t in tracing.tallies("micro_batch")
               for w in t.values["waits_s"])
    assert all(s.end_ns >= s.start_ns for s in _named("queue_wait"))


@pytest.mark.parametrize("n", [1, 9, 32])
def test_encode_texts_counts_real_and_launched_rows_and_tokens(tiny, n):
    params, arch, tok, tmpl = tiny
    enc = OnlineQueryEncoder(params, arch, tok, tmpl, SparseConfig(),
                             max_text_len=64, device="cpu")
    texts = [CAPTIONS[i % len(CAPTIONS)] for i in range(n)]
    ids, mask = tok.pad_batch(
        [tok.encode(tmpl.fill_text(tmpl.text_prompt(), t))
         for t in texts + [""] * (32 - n)], max_len=64, pad_to_multiple=16)
    want = {"rows_real": n, "rows_launched": 32,
            "tokens_real": int(mask[:n].sum()),
            "tokens_launched": 32 * ids.shape[1]}
    tracing.enable()
    got = {}
    with tracing.collect(got):
        dense, terms = enc.encode_texts(texts, pad_to=32)
    assert dense.shape[0] == len(terms) == n
    assert got == want
    (call,) = _named("encode_texts")
    assert want["tokens_real"] < want["tokens_launched"]
    for name in ("tokenize", "copy_back"):
        (child,) = _named(name)
        assert child.parent == call.id


# ---- indexing and training ---------------------------------------------------

def _tiny_internvl(tok):
    text = LlamaConfig(vocab_size=512, hidden_size=64, num_layers=2,
                       num_heads=4, num_kv_heads=2, intermediate_size=128)
    vit = InternViTConfig(hidden_size=32, num_layers=2, num_heads=4,
                          intermediate_size=64, image_size=28,
                          patch_size=14)
    arch = InternVLConfig(vision=vit, text=text,
                          image_token_id=tok.get_vocab()["<image>"],
                          max_dynamic_tiles=4)
    gen = torch.Generator().manual_seed(0)
    return init_params(arch, gen, "cpu", torch.float32), arch


def _images(n, rng):
    sizes = [(40, 60), (60, 40), (28, 28), (50, 90), (30, 30)]
    return [rng.random(sizes[i % len(sizes)] + (3,), dtype=np.float32)
            for i in range(n)]


@pytest.mark.parametrize("family", ["tiny_debug", "internvl"])
def test_encode_examples_spans_count_every_image(tiny, family):
    params, arch, tok, tmpl = tiny
    rng = np.random.default_rng(1)
    n = 7                                   # batches of 3: one padded
    if family == "internvl":
        params, arch = _tiny_internvl(tok)
        raw = _images(n, rng)
        loader = lambda ex: raw[int(ex.img_id)]   # noqa: E731
    else:
        pix = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
        loader = lambda ex: pix[int(ex.img_id)]   # noqa: E731
    exs = [Example("", "", "", str(i)) for i in range(n)]
    tracing.enable()
    out = encode_examples(exs, params, arch, tok, tmpl, encode_type="image",
                          sparse_cfg=SparseConfig(), batch_size=3,
                          pixel_loader=loader, device="cpu")
    assert out.ids == [str(i) for i in range(n)]
    prep = _named("preprocess")
    assert [s.attrs["images"] for s in prep] == [3, 3, 1]
    assert all(s.thread != threading.current_thread().name for s in prep)
    assert len(_named("prefetch_wait")) >= 1
    assert len(_named("resolve")) == 3
    assert len(_named("vit_attention")) == 0 if family == "tiny_debug" \
        else len(_named("vit_attention")) == 3 * arch.vision.num_layers
    assert all(set(s.attrs) == {"images"} for s in prep)


def test_encode_examples_text_preprocess_counts_texts(tiny):
    params, arch, tok, tmpl = tiny
    exs = [Example(c, "", f"t{k}", "") for k, c in enumerate(CAPTIONS)]
    tracing.enable()
    out = encode_examples(exs, params, arch, tok, tmpl, encode_type="text",
                          sparse_cfg=SparseConfig(), batch_size=4,
                          device="cpu")
    assert out.ids == [f"t{k}" for k in range(len(CAPTIONS))]
    assert [s.attrs for s in _named("preprocess")] == [{"texts": 4},
                                                       {"texts": 2}]
    assert len(_named("resolve")) == 2


def test_a_training_step_is_collate_then_train_step_and_its_stages(tiny):
    params, arch, tok, tmpl = tiny
    gen = torch.Generator().manual_seed(3)
    adapters = lora_lib.init_lora(gen, params, arch, rank=4, alpha=8,
                                  device="cpu")
    trainer = ContrastiveTrainer(
        params, arch, adapters,
        TrainConfig(learning_rate=1e-3, lora_rank=4, lora_alpha=8,
                    lora_dropout=0.0), device="cpu")
    collate = make_collator(tok, tmpl, arch)
    exs = [Example(c, f"/nonexistent/{k}.jpg", f"t{k}", f"i{k}")
           for k, c in enumerate(CAPTIONS[:4])]
    tracing.enable()
    loss = trainer.train_on_batch(collate(exs), blocking=False)
    assert torch.isfinite(loss)
    top = [s for s in tracing.spans() if s.parent is None]
    assert [s.name for s in top] == ["collate", "train_step"]
    assert top[0].attrs == {"images": 4}
    step = top[1]
    kids = sorted((s for s in tracing.spans() if s.parent == step.id),
                  key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ["to_device", "forward", "backward",
                                      "optimizer"]
    assert top[0].end_ns <= step.start_ns
    assert all(step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
               for s in kids)

"""The readers of the program's spans and tallies: each fed a synthetic
profiled slice (``Trace``), span log or tallies, and checked by hand; each
finds nothing (``None``) where its spans or tallies are absent, as on a
program without the tracing module."""

from collections import namedtuple

import pytest

from portbench import core, spanlog
from portbench.trace import Trace

Entry = namedtuple("Entry", "name start_ns end_ns attrs")
Tally = namedtuple("Tally", "traced values")
MS = 1_000_000
WINDOW = ("serve.queue_wait_p95_ms", "serve.pad_share")

NEW = ("serve.queue_wait_p95_ms", "serve.pad_share",
       "index.preprocess_ms_per_image", "index.prefetch_wait_ms_per_image",
       "vit_attention_ms_per_image", "train.collate_ms",
       "train.optimizer_ms")


def _read(name, layer, log=None):
    reader = core.metric_reader(name)
    if name == "vit_attention_ms_per_image":
        return reader.read(layer)
    if name in WINDOW:
        return reader.read(layer, tallies=log)
    return reader.read(layer, log=log)


def _e(name, start_ms, end_ms, **attrs):
    return Entry(name, int(start_ms * MS), int(end_ms * MS), attrs)


def _batch(traced, waits_ms, real=0, launched=0):
    return Tally(traced, {"waits_s": [w / 1e3 for w in waits_ms],
                          "rows_real": len(waits_ms), "rows_launched": 32,
                          "tokens_real": real, "tokens_launched": launched})


def test_queue_wait_p95_is_the_waits_percentile():
    """The window's batches are the last ``serve_batches`` untraced ones:
    the warm-up's before them and the traced slice's after are left out."""
    kept = [_batch(False, [900.0] * 5),                      # warm-up
            _batch(False, range(1, 11)), _batch(False, range(11, 21)),
            _batch(True, [500.0] * 30)]                      # the slice
    assert _read("serve.queue_wait_p95_ms", {"serve_batches": 2}, kept) \
        == pytest.approx(19.05)                              # 1..20 ms


def test_pad_share_sums_tokens_over_the_encode_calls():
    kept = [_batch(False, [1.0] * 20, 600, 32 * 48),
            _batch(False, [1.0] * 32, 1000, 32 * 48),
            _batch(True, [1.0] * 5, 10, 32 * 48)]
    assert _read("serve.pad_share", {"serve_batches": 2}, kept) == \
        pytest.approx(100.0 * (1 - 1600 / 3072))
    assert _read("serve.pad_share", {"serve_batches": 1}, kept) == \
        pytest.approx(100.0 * (1 - 1000 / 1536))


def test_preprocess_ms_per_image_over_the_images_the_spans_count():
    log = [_e("preprocess", 0, 80, images=8),
           _e("preprocess", 100, 150, images=2),
           _e("preprocess", 200, 900, texts=4),
           _e("prefetch_wait", 0, 80)]
    assert _read("index.preprocess_ms_per_image", {}, log) == \
        pytest.approx(130 / 10)


def test_prefetch_wait_ms_per_image_over_the_chunks_images():
    log = [_e("prefetch_wait", 0, 80), _e("prefetch_wait", 200, 210),
           _e("preprocess", 0, 80, images=8)]
    assert _read("index.prefetch_wait_ms_per_image", {"images": 16}, log) \
        == pytest.approx(90 / 16)


def test_vit_attention_reads_the_device_time_inside_its_ranges():
    tr = Trace(window_s=1e-3, t0_us=0.0)
    tr.kernels = [("gemm_f32", 10.0, 30.0), ("softmax", 30.0, 40.0),
                  ("gemm_bf16", 50.0, 90.0), ("gemm_f32", 110.0, 130.0)]
    tr.spans = [("vision", 0.0, 200.0), ("vit_attention", 5.0, 45.0),
                ("vit_attention", 100.0, 140.0)]
    assert _read("vit_attention_ms_per_image",
                 {"trace": tr, "images": 2}) == pytest.approx(50e-3 / 2)


def test_training_readers_are_per_step():
    log = [_e("collate", 0, 300, images=4),
           _e("to_device", 301, 302), _e("forward", 302, 1500),
           _e("backward", 1500, 3000), _e("optimizer", 3000, 3200),
           _e("train_step", 301, 3201),
           _e("collate", 4000, 4100, images=4),
           _e("optimizer", 4200, 4300), _e("train_step", 4100, 4400)]
    assert _read("train.collate_ms", {}, log) == pytest.approx(400 / 2)
    assert _read("train.optimizer_ms", {}, log) == pytest.approx(300 / 2)


@pytest.mark.parametrize("name", NEW)
def test_a_reader_finds_nothing_without_its_spans(name):
    layer = {"trace": Trace(window_s=1e-3), "images": 16}
    if name == "vit_attention_ms_per_image":
        layer["trace"].spans = [("vision", 0.0, 10.0)]
        layer["trace"].kernels = [("gemm", 1.0, 2.0)]
    layer["serve_batches"] = 3
    other = [_e("run_batch", 0, 1, batch=0, rows=1), _e("tower", 0, 1)]
    if name in WINDOW:
        other = [_batch(True, [1.0], 1, 2)]       # a traced batch only
    assert _read(name, layer, other) is None
    assert _read(name, {}, []) is None


def test_readers_take_the_programs_log_by_default():
    from mllm_sparse_retrieval_tpu_torch import tracing

    tracing.clear()
    try:
        tracing.tally("micro_batch", waits_s=[0.004], tokens_real=3,
                      tokens_launched=4)
        tracing.enable()
        tracing.tally("micro_batch", waits_s=[9.0], tokens_real=0,
                      tokens_launched=4)
        with tracing.span("prefetch_wait"):
            pass
        assert [s.name for s in spanlog.log()] == ["prefetch_wait"]
        layer = {"serve_batches": 1, "images": 1}
        assert _read("serve.queue_wait_p95_ms", layer) == \
            pytest.approx(4.0)
        assert _read("serve.pad_share", layer) == pytest.approx(25.0)
        assert _read("index.prefetch_wait_ms_per_image", layer) >= 0
    finally:
        tracing.disable()
        tracing.clear()


def test_every_new_metric_is_declared_for_its_cells():
    bench = core.benchmark()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = declared[name]
        for cell in m["workloads"]:
            assert m in core.per_layer_metrics(bench, cell)

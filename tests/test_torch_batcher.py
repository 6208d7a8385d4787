"""PyTorch port, ``MicroBatcher`` (a copy of the JAX package's) and the
kernel build helper. The batcher scenarios run against both packages'
classes and must behave the same."""

import threading
import time
from concurrent.futures import wait

import pytest

from mllm_sparse_retrieval_tpu.serving.batcher import (
    MicroBatcher as JMicroBatcher)
from mllm_sparse_retrieval_tpu_torch.ops import cuda_build
from mllm_sparse_retrieval_tpu_torch.serving.batcher import MicroBatcher

BATCHERS = {"port": MicroBatcher, "jax": JMicroBatcher}


@pytest.mark.parametrize("which", sorted(BATCHERS))
def test_burst_coalesces_and_results_route_back(which):
    sizes = []
    gate = threading.Event()

    def run(items):
        gate.wait(5)
        sizes.append(len(items))
        return [x * 10 for x in items]

    mb = BATCHERS[which](run, max_batch=4, max_wait_ms=50.0)
    try:
        first = mb.submit(0)          # opens a batch held at the gate
        time.sleep(0.05)
        futs = [mb.submit(i) for i in range(1, 9)]
        gate.set()
        done, _ = wait([first] + futs, timeout=10)
        assert len(done) == 9
        assert [f.result() for f in futs] == [i * 10 for i in range(1, 9)]
    finally:
        mb.close()
    assert sum(sizes) == 9 and max(sizes) <= 4
    assert mb.stats()["items"] == 9


@pytest.mark.parametrize("which", sorted(BATCHERS))
def test_errors_fail_the_batch_and_the_thread_keeps_serving(which):
    def run(items):
        if "bad" in items:
            raise ValueError("bad item")
        return items

    mb = BATCHERS[which](run, max_batch=8, max_wait_ms=1.0)
    try:
        with pytest.raises(ValueError, match="bad item"):
            mb.submit("bad").result(10)
        assert mb.submit("good").result(10) == "good"
        assert mb.stats()["errors"] == 1
    finally:
        mb.close()
    assert not mb._thread.is_alive()
    assert mb._thread.daemon
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit("late")


@pytest.mark.parametrize("which", sorted(BATCHERS))
def test_cancelled_requests_are_dropped(which):
    gate = threading.Event()
    seen = []

    def run(items):
        gate.wait(5)
        seen.extend(items)
        return items

    mb = BATCHERS[which](run, max_batch=1, max_wait_ms=0.0)
    try:
        blocker = mb.submit("first")
        time.sleep(0.05)
        doomed = mb.submit("cancel-me")
        assert doomed.cancel()
        gate.set()
        assert blocker.result(10) == "first"
        assert mb.submit("after").result(10) == "after"
    finally:
        mb.close()
    assert "cancel-me" not in seen


def test_kernel_library_is_named_by_source_and_flags(tmp_path, monkeypatch):
    path = cuda_build.library_path("taat.cu")
    assert path.parent == cuda_build.BUILD_DIR
    assert path.name.startswith("taat_") and path.suffix == ".so"
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_build.library_path("taat.cu") != path


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cuda_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("taat.cu")

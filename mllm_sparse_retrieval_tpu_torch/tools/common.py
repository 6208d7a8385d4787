"""What the tools share: the device check, a device barrier for timed
windows, the hardware a measurement ran on, the card's peak rates, the
timers, and the seeded Zipf corpus and query draws (the JAX tools' draws,
consuming the generator in their order, so both packages search the same
corpus from the same seed)."""

import subprocess
import time

import numpy as np
import torch

# NVIDIA H100 SXM peaks (the datasheet's dense rates, no sparsity), the
# rates chip_smoke.py holds the kernels to
F32_OPS_PER_S = 67e12           # f32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # bf16 tensor cores
INT8_OPS_PER_S = 1979e12        # int8 tensor cores


def checked_device(device: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises (the tools do not fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device here; pass "
                           f"--device cpu to run on the CPU")
    return device


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def hardware(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (its name alone where
    nvidia-smi does not answer), or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


# ---- timers ------------------------------------------------------------------

def host_seconds(fn, device: torch.device):
    """``(fn(), seconds)`` on the host clock, the window ended by a device
    barrier so that it counts finished work."""
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def device_seconds(fn, device: torch.device, calls: int = 1) -> float:
    """Seconds per call of ``calls`` back-to-back ``fn()`` calls: between
    two CUDA events on the card (device time: the span the stream took,
    launch gaps included), on the host clock with a barrier on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) / calls
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / calls


def interleaved(legs, reps: int, device: torch.device, per: int = 1):
    """Host-clock A/B: ``reps`` rounds, each running every ``(name, fn)``
    of ``legs`` once in turn (so drift hits every leg alike), each window
    ended by a device barrier. Returns ``{name: [seconds / per, ...]}``."""
    times = {name: [] for name, _ in legs}
    for _ in range(reps):
        for name, fn in legs:
            _, s = host_seconds(fn, device)
            times[name].append(s / per)
    return times


# ---- seeded draws ---------------------------------------------------------------

def zipf_p(n: int) -> np.ndarray:
    """Term probabilities ``1 / rank``, normalised."""
    p = 1.0 / np.arange(1, n + 1)
    return p / p.sum()


def zipf_docs(rng: np.random.Generator, docs: int, terms: int, doc_k: int,
              p: np.ndarray):
    """``(doc_terms int32 [docs, doc_k], doc_weights f32 [docs, doc_k])``:
    Zipf term ids drawn in blocks of 4,096 rows (the JAX tools' loop; the
    generator is consumed in row order either way), then integer impact
    weights in ``[1, 350)``."""
    doc_terms = np.empty((docs, doc_k), np.int32)
    for i in range(0, docs, 4096):
        n = min(4096, docs - i)
        doc_terms[i:i + n] = rng.choice(terms, size=(n, doc_k), p=p)
    doc_weights = rng.integers(1, 350, size=(docs, doc_k)).astype(np.float32)
    return doc_terms, doc_weights


def zipf_queries(rng: np.random.Generator, n: int, terms: int, q_k: int,
                 p: np.ndarray):
    """``(term ids int64 [n, q_k], weights int64 [n, q_k])``: Zipf term
    ids, then integer query weights in ``[1, 300)``; callers cast as the
    JAX tools do."""
    q_idx = rng.choice(terms, size=(n, q_k), p=p)
    q_w = rng.integers(1, 300, size=(n, q_k))
    return q_idx, q_w


def normal_rows(rng: np.random.Generator, n: int, dim: int) -> np.ndarray:
    """``[n, dim]`` standard normal f32 rows."""
    return rng.normal(size=(n, dim)).astype(np.float32)

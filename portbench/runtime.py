"""Device plumbing the kinds share: derived seeds, the device barrier,
peak memory and freeing the program's state before the reference runs."""

from __future__ import annotations

import gc

import numpy as np
import torch


def sub_seed(seed: int, purpose: int) -> int:
    """A 64-bit seed for one purpose of a run, so each draw of a run is a
    function of ``--seed`` alone."""
    return (int(seed) * 1_000_003 + purpose * 7_919) % (2 ** 62)


def rng(seed: int, purpose: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63), purpose])


def generator(seed: int, purpose: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                               purpose))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_allocated())
    return 0


def release(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

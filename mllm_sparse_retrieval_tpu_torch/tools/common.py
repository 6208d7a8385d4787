"""What the runbooks share: the device check, a device barrier for timed
windows, and the hardware a measurement ran on."""

import subprocess

import torch


def checked_device(device: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises (the runbooks do not fall back to the CPU)."""
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

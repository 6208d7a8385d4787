"""Build the package's CUDA sources with plain ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file exposes an ``extern "C"`` interface and includes no
PyTorch header (only the shared ``csrc/*.cuh`` helpers), so one ``nvcc``
call builds it in seconds. The shared library is named by a hash of its
source, the headers and the flags, so a stale build is never loaded.
The flash kernels encode their TMA tensor maps on the host through
the runtime's driver entry point (``cudaGetDriverEntryPointByVersion``), so
nothing links ``-lcuda``.
No lock file is used: a build writes a file named by its process id and
renames it into place, which is atomic, so a build that was cut off leaves
nothing another process could wait on.

Nothing here runs at import time; the first kernel call builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC")
BUILD_TIMEOUT_S = 600
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"   # the CUDA toolkit's default

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(DEFAULT_NVCC):
        return DEFAULT_NVCC
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str) -> Path:
    """Where the shared library for ``csrc/<source>`` lives once built; its
    name hashes the source, every header in ``csrc/`` and the flags."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:16]}.so"


def build(source: str, verbose: bool = False) -> Tuple[Path, float, str]:
    """Compile ``csrc/<source>`` unless its library already exists.

    Returns ``(library path, seconds spent compiling, compiler messages)``;
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills per
    kernel) to the messages. Raises with nvcc's output if it fails.
    """
    so = library_path(source)
    if so.exists():
        return so, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(CSRC_DIR / source)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S)
    seconds = time.monotonic() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so, seconds, proc.stdout + proc.stderr


def load(source: str) -> ctypes.CDLL:
    """Build (first use only) and load ``csrc/<source>``; cached per
    process."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            so, _, _ = build(source)
            lib = ctypes.CDLL(str(so))
            _libs[source] = lib
        return lib

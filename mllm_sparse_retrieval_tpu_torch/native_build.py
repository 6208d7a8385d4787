"""One ``g++`` call at first use: the build of the port's host libraries
(``index/native`` and ``data/imageio``, bound with ``ctypes``; the
``hostops`` CPython extension).

A library lives in ``build/`` beside its source (gitignored), named by a
hash of the source, the compiler, the flags, the host and any further
parts its caller names (the interpreter, for an extension), so a stale
build, or one copied from another machine, is never loaded; a build writes
a file named by its process id and renames it into place, so concurrent
builds need no lock. There is no silent fallback: a build that fails
raises. The compiler is ``$CXX``, else ``g++``.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Sequence

BUILD_TIMEOUT_S = 120


def compiler() -> str:
    """The C++ compiler: ``$CXX``, else ``g++``."""
    return os.environ.get("CXX") or "g++"


def library_path(source: Path, stem: str, flags: Sequence[str],
                 hash_parts: Sequence[str] = ()) -> Path:
    """Where ``source``'s library lives once built."""
    digest = hashlib.sha256(source.read_bytes())
    for part in (compiler(), *flags, *hash_parts, platform.machine(),
                 platform.node()):
        digest.update(part.encode() + b"\0")
    return source.parent / "build" / f"{stem}_{digest.hexdigest()[:16]}.so"


def build(source: Path, stem: str, flags: Sequence[str], what: str,
          hash_parts: Sequence[str] = ()) -> Path:
    """Compile ``source`` unless its library exists; raises, naming
    ``what`` with the compiler's output, when the build fails."""
    so = library_path(source, stem, flags, hash_parts)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler(), *flags, "-o", str(tmp), str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"cannot build the {what}: {' '.join(cmd)}: "
                           f"{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"the {what} failed to build ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so

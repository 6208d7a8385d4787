"""Loader of the host helpers' CPython extension (``hostops.c``, the port's
copy of the JAX package's ``hostops``).

The extension is built at first use with one ``g++ -O2 -fPIC -shared``
call against the include directory of the interpreter that loads it (it
needs ``Python.h``) into ``build/`` beside this file (gitignored). Its name
hashes the source, the compiler, the flags, the include directory, the
interpreter (its ABI tag and version) and the host, so a stale build, or
one for another Python or machine, is never loaded; a build writes a file
named by its process id and renames it into place, so concurrent builds
need no lock. There is no silent fallback: when the extension cannot be
built or loaded, ``get`` raises.

What stays with the callers is the input dispatch: list-shaped input goes
to C, anything else takes the caller's Python body, and so does input the
C function refuses (it raises ``TypeError`` / ``ValueError``, or returns
False). ``get`` hands out a wrapper that counts the calls of each function
that gave their caller its result (``call_counts``), so a run can show that
it went through C.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import platform
import subprocess
import sys
import sysconfig
import threading
from importlib.machinery import ExtensionFileLoader
from pathlib import Path
from typing import Dict, Optional

SOURCE = Path(__file__).resolve().parent / "hostops.c"
BUILD_DIR = SOURCE.parent / "build"
MODULE = "mllm_torch_hostops"
CXX_FLAGS = ("-O2", "-fPIC", "-shared")
FUNCTIONS = ("build_runs", "merge_topk_rows", "stack_rows", "encode_terms",
             "fuse_runs")
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_module: Optional["HostOps"] = None
_counts: Dict[str, int] = dict.fromkeys(FUNCTIONS, 0)


def compiler() -> str:
    """The compiler: ``$CXX``, else ``g++``."""
    return os.environ.get("CXX") or "g++"


def include_dir() -> str:
    """The running interpreter's C headers (``Python.h``)."""
    return sysconfig.get_paths()["include"]


def library_path() -> Path:
    """Where the extension lives once built, named by a hash of the source,
    the compiler, the flags, the include directory, the interpreter and the
    host."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    abi = sysconfig.get_config_var("EXT_SUFFIX") or sys.implementation.cache_tag
    for part in (compiler(), *CXX_FLAGS, include_dir(), abi, sys.version,
                 platform.machine(), platform.node()):
        digest.update(str(part).encode() + b"\0")
    return BUILD_DIR / f"{MODULE}_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the extension unless it exists; raises with the compiler's
    output when the build fails (a missing ``Python.h`` among the
    causes)."""
    so = library_path()
    if so.exists():
        return so
    header = os.path.join(include_dir(), "Python.h")
    if not os.path.exists(header):
        raise RuntimeError(f"cannot build hostops: {header} is missing (the "
                           f"interpreter's development headers)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler(), *CXX_FLAGS, f"-I{include_dir()}", "-o", str(tmp),
           str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"cannot build hostops: {' '.join(cmd)}: {e}") \
            from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"hostops failed to build ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load(so: Path):
    loader = ExtensionFileLoader(MODULE, str(so))
    spec = importlib.util.spec_from_file_location(MODULE, str(so),
                                                  loader=loader)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class HostOps:
    """The extension's five functions; each call that gives the caller its
    result is counted (not one that raises or returns False, after which
    the caller's Python body runs)."""

    def __init__(self, ext, path: Path):
        self.ext = ext
        self.path = path

    def _call(self, name, args):
        out = getattr(self.ext, name)(*args)
        if out is not False:           # False: the caller's body runs
            with _lock:
                _counts[name] += 1
        return out

    def build_runs(self, *args):
        return self._call("build_runs", args)

    def merge_topk_rows(self, *args):
        return self._call("merge_topk_rows", args)

    def stack_rows(self, *args):
        return self._call("stack_rows", args)

    def encode_terms(self, *args):
        return self._call("encode_terms", args)

    def fuse_runs(self, *args):
        return self._call("fuse_runs", args)


def get() -> HostOps:
    """The extension, built and loaded at first use; cached per process.
    Raises ``RuntimeError`` when it cannot be built."""
    global _module
    with _lock:
        if _module is None:
            so = build()
            _module = HostOps(_load(so), so)
        return _module


def call_counts() -> Dict[str, int]:
    """Calls of each C function that gave their caller its result, since
    the last ``reset_call_counts``."""
    with _lock:
        return dict(_counts)


def reset_call_counts() -> None:
    with _lock:
        for name in _counts:
            _counts[name] = 0

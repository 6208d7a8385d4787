"""Loader of the host helpers' CPython extension (``hostops.c``, the port's
copy of the JAX package's ``hostops``).

The extension is built at first use with one ``g++ -O2 -fPIC -shared``
call against the include directory of the interpreter that loads it (it
needs ``Python.h``) into ``build/`` beside this file (gitignored), by
``native_build``. Its name hashes the source, the compiler, the flags (the
include directory among them), the interpreter (its ABI tag and version)
and the host, so a stale build, or one for another Python or machine, is
never loaded. There is no silent fallback: when the extension cannot be
built or loaded, ``get`` raises.

What stays with the callers is the input dispatch: list-shaped input goes
to C, anything else takes the caller's Python body, and so does input the
C function refuses (it raises ``TypeError`` / ``ValueError``, or returns
False). ``get`` hands out a wrapper that counts the calls of each function
that gave their caller its result (``call_counts``), so a run can show that
it went through C.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import sysconfig
import threading
from importlib.machinery import ExtensionFileLoader
from pathlib import Path
from typing import Dict, Optional

from mllm_sparse_retrieval_tpu_torch import native_build

SOURCE = Path(__file__).resolve().parent / "hostops.c"
MODULE = "mllm_torch_hostops"
CXX_FLAGS = ("-O2", "-fPIC", "-shared")
FUNCTIONS = ("build_runs", "merge_topk_rows", "stack_rows", "encode_terms",
             "fuse_runs")

_lock = threading.Lock()
_module: Optional["HostOps"] = None
_counts: Dict[str, int] = dict.fromkeys(FUNCTIONS, 0)


def compiler() -> str:
    """The compiler: ``$CXX``, else ``g++``."""
    return native_build.compiler()


def include_dir() -> str:
    """The running interpreter's C headers (``Python.h``)."""
    return sysconfig.get_paths()["include"]


def _flags_and_parts():
    abi = sysconfig.get_config_var("EXT_SUFFIX") or sys.implementation.cache_tag
    return (*CXX_FLAGS, f"-I{include_dir()}"), (abi, sys.version)


def library_path() -> Path:
    """Where the extension lives once built, named by a hash of the source,
    the compiler, the flags, the include directory, the interpreter and the
    host."""
    return native_build.library_path(SOURCE, MODULE, *_flags_and_parts())


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
    flags, parts = _flags_and_parts()
    return native_build.build(SOURCE, MODULE, flags, "hostops extension",
                              parts)


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

"""ctypes binding for the native impact-index builder (``impact_builder.cc``,
the port's own copy of the JAX package's builder).

The library is built at first use with one ``g++`` call into ``build/``
beside this file (gitignored). Its name hashes the source, the compiler,
the flags and the host, so a stale build, or one copied from another
machine, is never loaded; a build writes a file named by its process id and
renames it into place, so concurrent builds need no lock. There is no
silent fallback: when the library cannot be built or loaded, ``load``
raises, and ``ImpactIndex.from_jsonl(use_native=True)`` with it. The
compiler is ``$CXX``, else ``g++``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict

import numpy as np

SOURCE = Path(__file__).resolve().parent / "impact_builder.cc"
BUILD_DIR = SOURCE.parent / "build"
# -march=native is left out (the JAX package's Makefile passes it): the
# library then runs on any CPU of the host's architecture
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}


def compiler() -> str:
    """The C++ compiler: ``$CXX``, else ``g++``."""
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    """Where the library lives once built, named by a hash of the source,
    the compiler, the flags and the host."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    for part in (compiler(), *CXX_FLAGS, platform.machine(),
                 platform.node()):
        digest.update(part.encode() + b"\0")
    return BUILD_DIR / f"libimpact_builder_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; raises with the compiler's
    output when the build fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"cannot build the native impact builder: "
                           f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"the native impact builder failed to build "
            f"({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}"
            f"{proc.stderr}")
    os.replace(tmp, so)
    return so


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, lng = ctypes.c_void_p, ctypes.c_long
    lib.ib_create.argtypes, lib.ib_create.restype = [], vp
    lib.ib_destroy.argtypes, lib.ib_destroy.restype = [vp], None
    lib.ib_add_jsonl.argtypes = [vp, ctypes.c_char_p, lng]
    lib.ib_add_jsonl.restype = lng
    lib.ib_add_doc.argtypes = [
        vp, ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int]
    lib.ib_add_doc.restype = None
    lib.ib_finalize.argtypes, lib.ib_finalize.restype = [vp], None
    for name in ("ib_num_docs", "ib_num_terms", "ib_nnz", "ib_terms_bytes",
                 "ib_docids_bytes"):
        getattr(lib, name).argtypes = [vp]
        getattr(lib, name).restype = lng
    lib.ib_kmax.argtypes, lib.ib_kmax.restype = [vp], ctypes.c_int
    for name, ctype in (("ib_get_doc_terms", ctypes.c_int32),
                        ("ib_get_doc_weights", ctypes.c_float),
                        ("ib_get_csr_offsets", ctypes.c_int64),
                        ("ib_get_csr_docs", ctypes.c_int32),
                        ("ib_get_csr_weights", ctypes.c_float)):
        getattr(lib, name).argtypes = [vp, ctypes.POINTER(ctype)]
        getattr(lib, name).restype = None
    for name in ("ib_get_terms", "ib_get_docids"):
        getattr(lib, name).argtypes = [vp, ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_int64)]
        getattr(lib, name).restype = None
    return lib


def load() -> ctypes.CDLL:
    """Build (first use) and load the library; cached per process and per
    library path."""
    with _lock:
        so = build()
        lib = _libs.get(so)
        if lib is None:
            lib = _libs[so] = _declare(ctypes.CDLL(str(so)))
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeImpactBuilder:
    """One builder handle: feed jsonl, then ``finalize`` to the packed and
    CSR arrays (the dict ``ImpactIndex._from_packed`` takes)."""

    def __init__(self):
        self._lib = load()
        self._h = self._lib.ib_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ib_destroy(self._h)
            self._h = None

    def add_jsonl_bytes(self, data: bytes) -> int:
        """Add every document of a jsonl buffer; returns how many."""
        n = self._lib.ib_add_jsonl(self._h, data, len(data))
        if n < 0:
            raise ValueError("malformed corpus jsonl")
        return int(n)

    def add_jsonl_file(self, path: str) -> int:
        with open(path, "rb") as f:
            data = f.read()
        try:
            return self.add_jsonl_bytes(data)
        except ValueError as e:
            raise ValueError(f"{e} in {path}") from None

    def finalize(self) -> dict:
        lib, h = self._lib, self._h
        lib.ib_finalize(h)
        n, t = lib.ib_num_docs(h), lib.ib_num_terms(h)
        nnz, k = lib.ib_nnz(h), lib.ib_kmax(h)
        doc_terms = np.empty(n * k, np.int32)
        doc_weights = np.empty(n * k, np.float32)
        csr_offsets = np.empty(t + 1, np.int64)
        csr_docs = np.empty(nnz, np.int32)
        csr_weights = np.empty(nnz, np.float32)
        lib.ib_get_doc_terms(h, _ptr(doc_terms, ctypes.c_int32))
        lib.ib_get_doc_weights(h, _ptr(doc_weights, ctypes.c_float))
        lib.ib_get_csr_offsets(h, _ptr(csr_offsets, ctypes.c_int64))
        lib.ib_get_csr_docs(h, _ptr(csr_docs, ctypes.c_int32))
        lib.ib_get_csr_weights(h, _ptr(csr_weights, ctypes.c_float))

        def strings(count, bytes_fn, get_fn):
            nb = bytes_fn(h)
            buf = ctypes.create_string_buffer(max(nb, 1))
            lengths = np.empty(count, np.int64)
            get_fn(h, buf, _ptr(lengths, ctypes.c_int64))
            raw, out, pos = buf.raw[:nb], [], 0
            for length in lengths.tolist():
                out.append(raw[pos:pos + length].decode("utf-8"))
                pos += length
            return out

        return {
            "doc_terms": doc_terms.reshape(n, k),
            "doc_weights": doc_weights.reshape(n, k),
            "csr_offsets": csr_offsets,
            "csr_docs": csr_docs,
            "csr_weights": csr_weights,
            "term_keys": strings(t, lib.ib_terms_bytes, lib.ib_get_terms),
            "doc_ids": strings(n, lib.ib_docids_bytes, lib.ib_get_docids),
        }

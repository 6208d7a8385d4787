"""Probe of the kernel build cache (``ops/cuda_build.py``).

Each CUDA source in ``csrc/`` is built once by a plain ``nvcc`` call into
``csrc/build/``, its library named by a hash of the source, every header
and the flags. This reports, for this machine, every input of that name:
the ``nvcc`` path and version, the flags, each source's hash and the
library name they give, and whether ``csrc/build/`` already holds it (a
hit). Then, unless ``--skip-compile``, it runs the headline TAAT program
(bench.py's shape: 25,010 docs of 128 Zipf terms over 20,000, 4,096
queries of 64 terms, depth 10) and reports its first-call seconds and
whether the TAAT library was built by that call (a miss) or found.

It prints one JSON object; ``--fingerprints PATH`` also appends it as one
line to PATH, so runs on different machines can be compared.

    python -m mllm_sparse_retrieval_tpu_torch.tools.cache_probe \\
        [--skip-compile] [--fingerprints PATH] [--device cuda]

``main`` returns the printed object.
"""

import argparse
import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from mllm_sparse_retrieval_tpu_torch.tools.common import (
    checked_device, hardware, sync, zipf_docs, zipf_p, zipf_queries)

# bench.py's headline shape
N_DOCS = 25_010
N_TERMS = 20_000
DOC_K = 128
QUERY_TERMS = 64
BATCH = 4096
DEPTH = 10
SOURCES = ("taat.cu", "flash_attn.cu", "flash_attn_bwd.cu")


def build_corpus(rng):
    """bench.py's corpus: Zipf term ids in blocks of 4,096 docs, then
    integer impact weights in ``[1, 350)``."""
    return zipf_docs(rng, N_DOCS, N_TERMS, DOC_K, zipf_p(N_TERMS))


def build_queries(rng):
    """bench.py's queries: Zipf term ids, integer weights in ``[1, 300)``."""
    q_idx, q_w = zipf_queries(rng, BATCH, N_TERMS, QUERY_TERMS,
                              zipf_p(N_TERMS))
    return q_idx.astype(np.int32), q_w.astype(np.float32)


def _nvcc_version() -> str:
    from mllm_sparse_retrieval_tpu_torch.ops import cuda_build

    try:
        nvcc = cuda_build.nvcc_path()
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60)
        lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
        return f"{nvcc}: {lines[-1] if lines else out.returncode}"
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        return f"not found ({e})"


def fingerprint(device: torch.device) -> dict:
    from mllm_sparse_retrieval_tpu_torch.ops import cuda_build

    sources = {}
    for src in SOURCES:
        path = cuda_build.CSRC_DIR / src
        lib = cuda_build.library_path(src)
        sources[src] = {
            "source_sha": hashlib.sha256(path.read_bytes()).hexdigest()[:16],
            "library": lib.name,
            "hit": lib.exists()}
    headers = {h.name: hashlib.sha256(h.read_bytes()).hexdigest()[:16]
               for h in sorted(cuda_build.CSRC_DIR.glob("*.cuh"))}
    return {
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": _nvcc_version(),
        "nvcc_flags": " ".join(cuda_build.NVCC_FLAGS),
        "build_dir": str(cuda_build.BUILD_DIR),
        "headers": headers,
        "sources": sources,
        "device": str(device),
        "hardware": hardware(device),
    }


def headline_program_probe(device: torch.device) -> dict:
    """The headline TAAT program at bench.py's shape: first-call seconds
    (the build, when the library is missing, the load and the device
    matrix included) and whether the library was there before."""
    from mllm_sparse_retrieval_tpu_torch.index import ImpactIndex
    from mllm_sparse_retrieval_tpu_torch.ops import cuda_build

    rng = np.random.default_rng(0)
    doc_terms, doc_weights = build_corpus(rng)
    q_idx, q_w = build_queries(rng)
    index = ImpactIndex.from_packed_arrays(doc_terms, doc_weights,
                                           term_keys=range(N_TERMS),
                                           device=device)
    lib = cuda_build.library_path("taat.cu")
    before = lib.exists()
    t0 = time.time()
    index.search_encoded(q_idx, q_w, DEPTH, backend="taat")
    sync(device)
    first = time.time() - t0
    t0 = time.time()
    index.search_encoded(q_idx, q_w, DEPTH, backend="taat")
    sync(device)
    return {"first_call_s": round(first, 3),
            "second_call_s": round(time.time() - t0, 3),
            "library": lib.name, "built_by_this_call": not before,
            "cache_hit": before}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--skip-compile", action="store_true",
                    help="fingerprint only (no device program)")
    ap.add_argument("--fingerprints", default=None,
                    help="also append the JSON object as a line to this "
                         "file")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda needs a card")
    args = ap.parse_args(argv)
    device = checked_device(args.device)
    info = fingerprint(device)
    if not args.skip_compile:
        info["headline_probe"] = headline_program_probe(device)
    print(json.dumps(info, indent=2))
    if args.fingerprints:
        with open(args.fingerprints, "a") as f:
            f.write(json.dumps(info) + "\n")
        print(f"fingerprint appended to {args.fingerprints}",
              file=sys.stderr)
    return info


if __name__ == "__main__":
    main()

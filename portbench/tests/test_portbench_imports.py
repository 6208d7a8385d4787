"""Nothing the benchmark runs imports JAX, the JAX package or the repo's
JAX-era scripts; the reference imports nothing of the port either.
Module names are compared whole, before the first dot: the port's name
begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import core

BENCH = Path(core.BENCH_DIR)


def imported_tops(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".", 1)[0]


def test_no_file_imports_jax_or_the_jax_package():
    bad = {}
    for path in BENCH.rglob("*.py"):
        hits = set(imported_tops(path)) & set(core.FORBIDDEN)
        if hits:
            bad[str(path.relative_to(BENCH))] = sorted(hits)
    assert bad == {}


def test_reference_imports_nothing_of_the_port():
    bad = {}
    for path in (BENCH / "reference").rglob("*.py"):
        hits = set(imported_tops(path)) & (set(core.FORBIDDEN) | {core.PORT})
        if hits:
            bad[path.name] = sorted(hits)
    assert bad == {}


def test_whole_names_are_compared():
    assert core.PORT.startswith("mllm_sparse_retrieval_tpu")
    assert core.PORT not in core.FORBIDDEN


def test_loading_the_benchmark_and_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil\n"
        "import portbench.run, portbench.control, portbench.sweep\n"
        "import portbench.kinds as K\n"
        "for m in pkgutil.iter_modules(K.__path__):\n"
        "    importlib.import_module('portbench.kinds.' + m.name)\n"
        "import mllm_sparse_retrieval_tpu_torch.serving\n"
        "import mllm_sparse_retrieval_tpu_torch.pipelines.encode\n"
        "import mllm_sparse_retrieval_tpu_torch.train.trainer\n"
        "from portbench import core\n"
        "print(core.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=core.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_loaded_reads_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mllm_sparse_retrieval_tpu.fake",
                        sys.modules[__name__])
    assert core.forbidden_loaded() == ["mllm_sparse_retrieval_tpu"]

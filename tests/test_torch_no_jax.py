"""The PyTorch port and ``chip_smoke.py`` import nothing of JAX and nothing
of the JAX package (nor Pillow, ``transformers``, ``tokenizers`` or
``regex``, which the card machine lacks; the port decodes image files and
reads ``tokenizer.json`` with those blocked), every port
module (the offline evaluation path's ``cli``, ``eval``, ``search`` and
``index/native``, and the hybrid path's fusion, rank, filter and service
modules, the search tiers' SQ8, ANN, compact48 and stream modules, and
the live indexes, the HTTP front ends and the server CLIs, and the
chat-template families' Qwen2.5-VL, InternVL2.5, tiling and template
modules, and the training and analysis CLIs with ``data.prep``,
``eval.statistics`` and ``hostops`` included, and the mesh-training
modules ``parallel.{fsdp,tp,sp,pp,multihost,dryrun}``, and the
sentencepiece conversion ``models.sentencepiece``, and the runbooks of
``tools``) imports with JAX blocked (and, Qwen's native
resolution and InternVL's tiling among them, with Pillow blocked),
checkpoints convert and load with ``transformers`` and ``safetensors``
blocked too, and the smoke check refuses to report a result without a
card."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "mllm_sparse_retrieval_tpu_torch"

_BLOCK_AND_IMPORT = """
import importlib, pkgutil, sys
for name in list(sys.modules):
    if name.split('.')[0] in ('jax', 'jaxlib', 'mllm_sparse_retrieval_tpu'):
        del sys.modules[name]
for name in ('jax', 'jaxlib', 'mllm_sparse_retrieval_tpu'):
    sys.modules[name] = None          # any import of these now fails
import mllm_sparse_retrieval_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(' '.join(names))
print('imported', len(names))
"""

# the offline evaluation path's modules, which the walk must reach
OFFLINE = ("cli.common", "cli.encode", "cli.index", "cli.search",
           "data.karpathy", "eval.metrics", "eval.recall", "index.dense",
           "index.native", "ops.mips", "ops.stream", "pipelines.encode",
           "search.engine", "search.fusion", "search.runs")
# the hybrid path's modules
HYBRID = ("eval.device_eval", "index.filter", "ops.eval_ranks",
          "ops.hybrid_fusion", "search.device_fusion", "serving.service")
# the search tiers' modules: the ANN tier, SQ8, the compact48 wire, streams
TIERS = ("index.ann", "index.impact", "index", "ops.ann", "ops.mips",
         "ops.packing", "ops.score_programs")
# the live indexes, the HTTP front ends and the server CLIs
LIVE = ("index.arena", "index.live", "serving.router", "serving.http",
        "serving.aio", "cli.serve", "cli.ingest")
# the chat-template families
CHAT = ("models.qwen_vl", "models.internvl", "data.tiling",
        "models.templates", "models.api", "models.registry",
        "models.convert")
# training and analysis entry points, and the host helpers
TRAIN = ("hostops", "cli.train", "cli.prepare_data", "cli.stats",
         "data.prep", "eval.statistics", "train.trainer")
# k-bit base weights (QLoRA), the mixture-of-experts FFN, and the meshes
# of search, encode and serve
QLORA = ("models.quantization", "parallel", "parallel.ep", "parallel.mesh")
# training over a mesh: FSDP, tensor, sequence and pipeline parallelism, the
# process group, the dry run and the sharded loss
MESH_TRAIN = ("parallel.fsdp", "parallel.tp", "parallel.sp", "parallel.pp",
              "parallel.multihost", "parallel.dryrun", "train.contrastive")
# a tokenizer.model-only checkpoint: the sentencepiece conversion and the
# reader it feeds
SPM = ("models.sentencepiece", "models.hf_tokenizer")
# the end-to-end runbooks and the helpers they share
TOOLS = ("tools", "tools.common", "tools.reproduce_recall",
         "tools.train_retrieve_e2e", "tools.corpus_e2e")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run([sys.executable, "-c", _BLOCK_AND_IMPORT],
                          cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20
    imported = set(proc.stdout.splitlines()[-2].split())
    missing = {m for m in OFFLINE + HYBRID + TIERS + LIVE + CHAT + TRAIN
               + QLORA + MESH_TRAIN + SPM + TOOLS
               if f"mllm_sparse_retrieval_tpu_torch.{m}" not in imported}
    assert missing == set()


def test_no_import_statement_names_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|mllm_sparse_retrieval_tpu)\b",
        re.MULTILINE)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "chip_flash_ab.py"]
    assert len(files) > 20
    scanned = {str(f.relative_to(PORT)) for f in files
               if f.is_relative_to(PORT)}
    assert {m.replace(".", "/") + ".py"
            for m in OFFLINE + HYBRID + TIERS + LIVE + CHAT + QLORA
            + MESH_TRAIN + SPM + TOOLS
            if m not in ("index.native", "index", "parallel", "tools")} | {
                "index/native/__init__.py", "index/__init__.py",
                "parallel/__init__.py", "tools/__init__.py"} <= scanned
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in pattern.finditer(f.read_text())]
    assert hits == []


def test_port_imports_no_pillow():
    script = _BLOCK_AND_IMPORT.replace(
        "('jax', 'jaxlib', 'mllm_sparse_retrieval_tpu')",
        "('jax', 'jaxlib', 'mllm_sparse_retrieval_tpu', 'PIL')")
    assert script != _BLOCK_AND_IMPORT
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    pattern = re.compile(r"^\s*(import|from)\s+PIL\b", re.MULTILINE)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert [f for f in files if pattern.search(f.read_text())] == []


_CONVERT_BLOCKED = """
import sys
for name in list(sys.modules):
    if name.split('.')[0] in BLOCKED:
        del sys.modules[name]
for name in BLOCKED:
    sys.modules[name] = None          # any import of these now fails
from mllm_sparse_retrieval_tpu_torch.models import convert
convert.convert_hf_dir(sys.argv[1], sys.argv[2])
params, tok, arch = convert.load_converted(sys.argv[2], None, device="cpu")
print(tok, arch.text.num_kv_heads, len(params["text"]["blocks"]),
      sorted(params))
"""


def test_checkpoints_convert_and_load_without_jax_transformers_safetensors(
        tmp_path):
    transformers = pytest.importorskip("transformers")
    import torch

    cfg = transformers.LlavaNextConfig(
        vision_config=transformers.CLIPVisionConfig(
            hidden_size=32, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, image_size=28, patch_size=14),
        text_config=transformers.LlamaConfig(
            vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=1),
        image_token_index=60, image_grid_pinpoints=[[28, 56], [56, 28]])
    torch.manual_seed(0)
    transformers.LlavaNextForConditionalGeneration(cfg).save_pretrained(
        str(tmp_path / "hf"))
    _write_tokenizer(tmp_path / "hf")
    blocked = ("jax", "jaxlib", "mllm_sparse_retrieval_tpu", "transformers",
               "safetensors", "tokenizers", "PIL", "regex")
    script = f"BLOCKED = {blocked!r}\n" + _CONVERT_BLOCKED
    proc = subprocess.run(
        [sys.executable, "-c", script, str(tmp_path / "hf"),
         str(tmp_path / "out")], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[0] == (
        "HFJsonTokenizer(vocab_size=5) 1 3 "
        "['image_newline', 'projector', 'text', 'vision']")
    assert (tmp_path / "out" / "tokenizer.json").read_text() == \
        (tmp_path / "hf" / "tokenizer.json").read_text()


def _write_tokenizer(path):
    """A five-token word-level tokenizer.json (no library needed)."""
    vocab = {"<unk>": 0, "▁a": 1, "▁dog": 2, "▁cat": 3}
    (path / "tokenizer.json").write_text(json.dumps({
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": 4, "content": "<image>", "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True}],
        "normalizer": None,
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁",
                          "prepend_scheme": "always", "split": True},
        "post_processor": None, "decoder": None,
        "model": {"type": "WordLevel", "vocab": vocab,
                  "unk_token": "<unk>"}}))


_READ_BLOCKED = """
import sys
import numpy as np
for name in list(sys.modules):
    if name.split('.')[0] in BLOCKED:
        del sys.modules[name]
for name in BLOCKED:
    sys.modules[name] = None          # any import of these now fails
import importlib, pkgutil
import mllm_sparse_retrieval_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
from mllm_sparse_retrieval_tpu_torch.data.imageio import load_rgb
from mllm_sparse_retrieval_tpu_torch.models.hf_tokenizer import (
    HFJsonTokenizer)
img = load_rgb(sys.argv[1])
tok = HFJsonTokenizer.from_dir(sys.argv[2])
print(len(names), img.shape, int(img.astype(np.int64).sum()),
      tok.encode("a dog<image> cat"))
"""


def test_port_decodes_images_and_reads_tokenizers_with_the_libraries_blocked(
        tmp_path):
    """Every port module and ``chip_smoke.py`` import, a JPEG decodes and a
    ``tokenizer.json`` is read, with JAX, ``transformers``, ``tokenizers``,
    Pillow and ``regex`` blocked, as they are missing on the card
    machine; no port source imports any of them."""
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)).save(
        buf, "JPEG", quality=90)
    (tmp_path / "x.jpg").write_bytes(buf.getvalue())
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    _write_tokenizer(tmp_path)
    blocked = ("jax", "jaxlib", "mllm_sparse_retrieval_tpu", "transformers",
               "tokenizers", "PIL", "regex")
    proc = subprocess.run(
        [sys.executable, "-c", f"BLOCKED = {blocked!r}\n" + _READ_BLOCKED,
         str(tmp_path / "x.jpg"), str(tmp_path)], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n, rest = proc.stdout.split(" ", 1)
    assert int(n) >= 20
    assert rest.strip() == (f"(9, 13, 3) {int(want.astype(np.int64).sum())}"
                            f" [1, 2, 4, 3]")
    pattern = re.compile(
        r"^\s*(import|from)\s+(transformers|tokenizers|PIL|regex)\b",
        re.MULTILINE)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert [f for f in files if pattern.search(f.read_text())] == []


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, where):
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_live_entry_points_default_to_the_card():
    """The live indexes, their loaders, ``load_live_state`` and the server
    CLIs put the indexes and the model on ``cuda`` unless asked."""
    import inspect

    from mllm_sparse_retrieval_tpu_torch.cli import serve
    from mllm_sparse_retrieval_tpu_torch.index import (
        ArenaDenseIndex, ArenaImpactIndex, LiveDenseIndex, LiveImpactIndex)
    from mllm_sparse_retrieval_tpu_torch.serving import load_live_state

    fns = [load_live_state]
    for cls in (ArenaDenseIndex, ArenaImpactIndex, LiveDenseIndex,
                LiveImpactIndex):
        fns += [cls.__init__, cls.load] if "device" in inspect.signature(
            cls.load).parameters else [cls.__init__]
    assert len(fns) == 7
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    args = serve.build_parser().parse_args(["--live-empty", "sparse"])
    assert args.device == "cuda"


def test_chat_family_entry_points_default_to_the_card():
    """The chat-template families' weight draws and the registry put the
    model on ``cuda`` unless asked."""
    import inspect

    from mllm_sparse_retrieval_tpu_torch.models import (
        internvl, qwen_vl, registry)

    for fn in (internvl.init_params, qwen_vl.init_params,
               registry.init_params, registry.build_model):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_moe_and_qlora_entry_points_default_to_the_card():
    """MoE weights are drawn on ``cuda`` unless asked; the train CLI (which
    quantizes the base where the model lives) runs there too."""
    import inspect

    from mllm_sparse_retrieval_tpu_torch.cli import train
    from mllm_sparse_retrieval_tpu_torch.parallel import ep

    assert inspect.signature(ep.moe_init).parameters["device"].default == \
        "cuda"
    args = train.build_parser().parse_args(["--load-kbit", "4"])
    assert (args.device, args.quant_format) == ("cuda", "nf4")


def test_mesh_training_entry_points_default_to_the_card():
    """The dry run and the process group take the card unless asked; the
    train CLI's ``--mesh`` spans the cards of its ``cuda`` device."""
    import inspect

    from mllm_sparse_retrieval_tpu_torch.cli import train
    from mllm_sparse_retrieval_tpu_torch.parallel import dryrun, multihost

    for fn in (dryrun.dryrun_multichip, dryrun.dryrun_devices,
               multihost.initialize_multihost):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    args = train.build_parser().parse_args(["--mesh"])
    assert (args.device, args.mesh) == ("cuda", True)


def test_qwen_checkpoint_converts_with_jax_and_transformers_blocked(
        tmp_path):
    """A Qwen2.5-VL checkpoint in the hub's key layout (two shards and an
    index, a tied head) converts and loads with ``jax``, the JAX package,
    ``transformers`` and ``safetensors`` blocked."""
    from safetensors.numpy import save_file

    from tests.test_torch_qwen_vl import _hf_config, _hf_state_dict, _jarch

    arch = _jarch()
    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "config.json").write_text(json.dumps(_hf_config(arch)))
    sd = _hf_state_dict(arch, 0, "hub", tied=True)
    save_file(sd, str(hf / "model.safetensors"))
    blocked = ("jax", "jaxlib", "mllm_sparse_retrieval_tpu", "transformers",
               "safetensors", "PIL")
    script = f"BLOCKED = {blocked!r}\n" + _CONVERT_BLOCKED
    proc = subprocess.run(
        [sys.executable, "-c", script, str(hf), str(tmp_path / "out")],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[0] == "None 2 2 ['text', 'vision']"

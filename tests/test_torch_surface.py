"""PyTorch port, its public surface against the JAX package's, read with
``ast`` (nothing is imported): every module of ``mllm_sparse_retrieval_tpu/``
against the module of the same path in the port, and every script of
``tools/`` and ``examples/`` against the port's ``tools/`` and
``examples/``.

Compared, per module pair: the module-level functions and classes whose
names do not start with ``_``, the public methods and ``__init__`` of those
classes, the parameter names of each, and the flags of the module's
``add_argument`` calls. Module-level constants are not compared: most of
the JAX package's are the Pallas kernels' tile sizes. A name, parameter or
flag of the JAX package that the port lacks is a departure. The test holds
the set of departures equal to ``DEPARTURES``, each with its reason, so a
new gap fails and so does a pinned departure that the port closes without
taking it out of the list. The same holds for the one JAX script without a
counterpart (``MODULES_NOT_PORTED``).

Last, the helpers added to close the walk's other gaps against their JAX
versions: ``layers.full_padding_mask`` (exact) and the ``Tokenizer``
protocol.
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import torch

from mllm_sparse_retrieval_tpu.models import layers as jlayers
from mllm_sparse_retrieval_tpu.models import tokenizer as jtokenizer
from mllm_sparse_retrieval_tpu_torch.models import layers, tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PORT = "mllm_sparse_retrieval_tpu", "mllm_sparse_retrieval_tpu_torch"

TPU_ONLY = ("the TPU kernel's interpret mode, tiling or JAX compile cache; "
            "the CUDA kernels and the port's build cache have none")
FILTERED = ("the JAX package compiles one program per filter state; the "
            "port's program takes the filter as mask=")
KEYS = ("JAX PRNG keys become a torch.Generator, or a layers.ParamDraw "
        "that holds one with the device and dtype")
LORA_SEED = ("LoRA dropout takes an integer seed (lora_seed, "
             "layers.fold_seed) in place of a JAX key (lora_rng)")
NO_FALLBACK = ("the port builds the native code at first use or raises; "
               "there is no Python fallback to report as unavailable")

DEPARTURES = {
    # TPU only
    "cli/common.py:enable_compilation_cache": TPU_ONLY,
    "cli/common.py:stabilize_cache_key": TPU_ONLY,
    "ops/impact_kernel.py:impact_scores_taat(interpret)": TPU_ONLY,
    "ops/impact_kernel.py:impact_scores_taat(max_sub_block)": TPU_ONLY,
    "ops/impact_kernel.py:padded_doc_columns": TPU_ONLY,
    "ops/impact_kernel.py:plan_column_blocks": TPU_ONLY,
    "tools/serve_loadtest.py:--platform":
        "a JAX platform name; the port's tools take --device",
    # idiom: integer dropout seeds
    "models/api.py:encode_any(lora_rng)": LORA_SEED,
    "models/internvl.py:encode(lora_rng)": LORA_SEED,
    "models/layers.py:dense(lora_rng)": LORA_SEED,
    "models/llama.py:apply(lora_rng)": LORA_SEED,
    "models/mllm.py:encode(lora_rng)": LORA_SEED,
    "models/mllm.py:forward_hidden(lora_rng)": LORA_SEED,
    "models/qwen_vl.py:encode(lora_rng)": LORA_SEED,
    # idiom: filters as masks
    "ops/ann.py:ann_topk_packed_filtered": FILTERED,
    "ops/ann.py:sharded_ann_topk_filtered": FILTERED,
    "ops/mips.py:mips_topk_packed_filtered": FILTERED,
    "ops/mips.py:mips_topk_packed_q8_filtered": FILTERED,
    "ops/mips.py:sharded_mips_topk_filtered": FILTERED,
    "ops/mips.py:sharded_mips_topk_q8_filtered": FILTERED,
    # idiom: generators for keys
    "models/layers.py:dense_init": KEYS,
    "models/layers.py:rmsnorm_init": KEYS,
    "models/layers.py:layernorm_init": KEYS,
    "models/layers.py:lora_init(key)": KEYS,
    "models/internvl.py:init_params(key)": KEYS,
    "models/internvl.py:init_vision_params(key)": KEYS,
    "models/internvl.py:init_vision_params(dtype)": KEYS,
    "models/llama.py:init_params(key)": KEYS,
    "models/lora.py:init_lora(key)": KEYS,
    "models/mllm.py:init_params(key)": KEYS,
    "models/qwen_vl.py:init_params(key)": KEYS,
    "models/qwen_vl.py:init_vision_params(key)": KEYS,
    "models/qwen_vl.py:init_vision_params(dtype)": KEYS,
    "models/vit.py:init_params(key)": KEYS,
    "parallel/ep.py:moe_init(key)": KEYS,
    # idiom: the rest
    **{f"parallel/sp.py:ring_attention({p})":
       "no shard_map: the port's ring attention takes the sequence as "
       "lists of chunks, one per device (qs, ks, vs, kv_masks)"
       for p in ("q", "k", "v", "kv_mask", "axis_name", "n_chunks")},
    "index/filter.py:DocFilter.device_mask(mesh)":
        "the port's device= takes a device or a Mesh",
    "parallel/mesh.py:replicated(array)":
        "the port's replicated(mesh, tree) places a whole tree per shard",
    "pipelines/encode.py:make_text_ds_encode(allow_flash)":
        "no jit to close over: the returned function takes allow_flash",
    "pipelines/encode.py:make_image_ds_encode(allow_flash)":
        "no jit to close over: the returned function takes allow_flash",
    "cli/common.py:build_everything(mode_for_captions)":
        "unused by every JAX caller",
    # the no-fallback rule
    "hostops/__init__.py:available": NO_FALLBACK,
    "index/native/__init__.py:available": NO_FALLBACK,
}

MODULES_NOT_PORTED = {
    "tools/tpu_checks.py": "the TPU's checklist; its counterpart is "
                           "chip_smoke.py",
}


def _pairs():
    """``(key, JAX path, port path)`` of every module and script."""
    out = []
    base = os.path.join(ROOT, JAX)
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), base)
                out.append((rel, os.path.join(JAX, rel),
                            os.path.join(PORT, rel)))
    for d in ("tools", "examples"):
        for f in os.listdir(os.path.join(ROOT, d)):
            if f.endswith(".py"):
                out.append((f"{d}/{f}", os.path.join(d, f),
                            os.path.join(PORT, d, f)))
    return sorted(out)


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    if a.kwarg:
        names.append("**" + a.kwarg.arg)
    return names


def _surface(path):
    """``({public name: its parameters}, {add_argument flags})``."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    defs = (ast.FunctionDef, ast.AsyncFunctionDef)
    names, flags = {}, set()
    for node in tree.body:
        if isinstance(node, defs) and not node.name.startswith("_"):
            names[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and \
                not node.name.startswith("_"):
            names[node.name] = []
            for m in node.body:
                if isinstance(m, defs) and (not m.name.startswith("_")
                                            or m.name == "__init__"):
                    names[f"{node.name}.{m.name}"] = _params(m)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", None) == "add_argument":
            flags.update(a.value for a in node.args
                         if isinstance(a, ast.Constant)
                         and isinstance(a.value, str))
    return names, flags


def _departures():
    found, unpaired = set(), set()
    for key, jpath, ppath in _pairs():
        if not os.path.exists(os.path.join(ROOT, ppath)):
            unpaired.add(key)
            continue
        jnames, jflags = _surface(jpath)
        pnames, pflags = _surface(ppath)
        for name, params in jnames.items():
            if name not in pnames:
                found.add(f"{key}:{name}")
                continue
            found.update(f"{key}:{name}({p})" for p in params
                         if p not in pnames[name])
        found.update(f"{key}:{flag}" for flag in jflags - pflags)
    return found, unpaired


def test_surface_departures_are_the_pinned_ones():
    found, unpaired = _departures()
    assert sorted(found - set(DEPARTURES)) == []      # new gaps
    assert sorted(set(DEPARTURES) - found) == []      # closed, still pinned
    assert unpaired == set(MODULES_NOT_PORTED)
    assert all(DEPARTURES.values()) and all(MODULES_NOT_PORTED.values())


def test_surface_walk_sees_what_it_compares():
    """The walk reads names, parameters and flags: a public function, a
    method's parameters and the CLI flags of each package."""
    names, _ = _surface(f"{PORT}/train/trainer.py")
    assert names["ContrastiveTrainer.train_on_batch"] == [
        "self", "batch", "blocking"]
    assert "make_collator" in names and "_leaves" not in names
    flags = _surface(f"{PORT}/cli/train.py")[1]
    assert "--log-every" in flags
    assert _surface(f"{JAX}/cli/train.py")[1] <= flags
    assert _surface("tools/serve_loadtest.py")[1] - _surface(
        f"{PORT}/tools/serve_loadtest.py")[1] == {"--platform"}


def test_full_padding_mask_matches_jax():
    rng = np.random.default_rng(0)
    mask = (rng.random((3, 7)) < 0.6).astype(np.int32)
    mask[0] = 1
    mask[1] = 0
    got = layers.full_padding_mask(torch.from_numpy(mask))
    want = np.asarray(jlayers.full_padding_mask(jnp.asarray(mask)))
    assert got.dtype == torch.bool and tuple(got.shape) == (3, 1, 7, 7)
    np.testing.assert_array_equal(got.numpy(), want)


def _members(protocol):
    return set(protocol.__annotations__) | {
        n for n in vars(protocol) if not n.startswith("_")}


def test_tokenizers_give_the_tokenizer_protocol():
    """The port's ``Tokenizer`` has the JAX protocol's members, and the
    port's tokenizers have them."""
    members = _members(tokenizer.Tokenizer)
    assert members == _members(jtokenizer.Tokenizer) == {
        "pad_id", "get_vocab", "encode", "vocab_size"}
    tok = tokenizer.WordPieceLiteTokenizer.from_corpus_captions(
        ["a red car", "two dogs"], vocab_size=64)
    assert isinstance(tok.pad_id, int) and isinstance(tok.vocab_size, int)
    assert tok.encode("a red car", add_special_tokens=True)
    assert isinstance(tok.get_vocab(), dict)
    for cls in (tokenizer.WordPieceLiteTokenizer,
                tokenizer.HFTokenizerAdapter):
        assert {"get_vocab", "encode", "vocab_size"} <= set(dir(cls))

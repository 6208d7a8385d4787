"""PyTorch port, k-bit base weights (``models/quantization.py``) and QLoRA
training, against the JAX package on the CPU.

Quantized bytes are held to JAX ``quantize_weight`` on seeded ``[in, out]``
weights (odd row counts, rows that are no multiple of 64, a zero column):
``q`` byte for byte in every mode, linear scales exactly. The nf4 double
quantization sums its column mean in float64 (the same bytes on the CPU
and on the card), the JAX package in f32: ``scale_off`` and ``scale``
within ``rtol=2^-18`` (an ulp of the mean, which the max of the centered
absmax it divides magnifies) and ``scale_q`` within one step.
Dequantizing the same bytes (JAX's, carried across with
``from_jax_params``) gives JAX's values bit for bit. Models over a
quantized tree (f32): encodings within ``atol=rtol=1e-5``, three QLoRA
steps' losses within ``1e-5`` and their adapters within ``atol=rtol=1e-4``
(``test_torch_train.py``'s STEP_TOL), the CLI's ``lora.pkl`` likewise.
Over a bf16 tree the packages pick the same compute dtypes (the vision
tower in f32, as the scale's dtype says; the decoder in bf16), their
outputs within ``atol=rtol=2^-5`` (bf16 products summed in another order).
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.cli import train as jcli_train
from mllm_sparse_retrieval_tpu.configs import ModelConfig as JModelConfig
from mllm_sparse_retrieval_tpu.configs import ModelFamily as JFamily
from mllm_sparse_retrieval_tpu.configs import TrainConfig as JTrainConfig
from mllm_sparse_retrieval_tpu.models import build_model as j_build_model
from mllm_sparse_retrieval_tpu.models import lora as jlora
from mllm_sparse_retrieval_tpu.models import mllm as jmllm
from mllm_sparse_retrieval_tpu.models import quantization as JQ
from mllm_sparse_retrieval_tpu.models import vit as jvit
from mllm_sparse_retrieval_tpu.train import trainer as jtrainer
from mllm_sparse_retrieval_tpu_torch.cli import train as cli_train
from mllm_sparse_retrieval_tpu_torch.configs import (
    ModelConfig, ModelFamily, RepsLoc, TrainConfig)
from mllm_sparse_retrieval_tpu_torch.models import layers as L
from mllm_sparse_retrieval_tpu_torch.models import lora, mllm, vit
from mllm_sparse_retrieval_tpu_torch.models import quantization as Q
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import (
    from_jax_lora, from_jax_params)
from mllm_sparse_retrieval_tpu_torch.models.registry import get_family_spec
from mllm_sparse_retrieval_tpu_torch.train.trainer import ContrastiveTrainer
from test_torch_cli_train import _args, _close, data_root  # noqa: F401
from test_torch_train import (CAPTIONS, STEP_TOL, TINY, TOL, _adapters,
                              _examples, _np_tree, _port_batch, tiny)  # noqa
from tests.torch_threads import one_torch_thread  # noqa: F401

SCALE_RTOL = 2.0 ** -18
BF16_TOL = dict(atol=2.0 ** -5, rtol=2.0 ** -5)
SHAPES = [(64, 32), (130, 48), (511, 33), (1000, 70), (63, 17)]
MODES = [(8, "linear"), (4, "linear"), (4, "nf4")]


def _weight(shape, seed=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[:, 3] = 0.0                                  # a zero column
    return w


def _carry(jq):
    """A JAX QuantizedWeight (or tree) as the port's, the same bytes."""
    tree = from_jax_params({"embed": np.zeros(1), "blocks": [],
                            "final_norm": np.zeros(1),
                            "w": jax.tree_util.tree_map(np.asarray, jq)},
                           "cpu")
    return tree["text"]["w"]


@pytest.mark.parametrize("bits,mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_quantized_bytes_match_jax(shape, bits, mode):
    w = _weight(shape, seed=shape[0])
    j = JQ.quantize_weight(jnp.asarray(w), bits, mode)
    p = Q.quantize_weight(torch.from_numpy(w), bits, mode)
    assert (p.bits, p.mode, p.logical_shape) == (j.bits, j.mode,
                                                 j.logical_shape)
    assert (p.shape, p.ndim, p.nbytes) == (j.shape, j.ndim, j.nbytes)
    assert p.dtype == torch.float32 and j.dtype == jnp.float32
    np.testing.assert_array_equal(p.q.numpy(), np.asarray(j.q))
    if mode == "linear":
        np.testing.assert_array_equal(p.scale.numpy(), np.asarray(j.scale))
        assert p.scale_q is None and j.scale_q is None
    else:
        np.testing.assert_allclose(p.scale.numpy(), np.asarray(j.scale),
                                   rtol=SCALE_RTOL, atol=0)
        np.testing.assert_allclose(p.scale_off.numpy(),
                                   np.asarray(j.scale_off), rtol=SCALE_RTOL,
                                   atol=0)
        assert np.abs(p.scale_q.numpy().astype(int)
                      - np.asarray(j.scale_q).astype(int)).max() <= 1
    # the zero column dequantizes to exact zeros
    assert not Q.dequantize_weight(p)[:, 3].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,mode", MODES)
def test_dequantize_carried_bytes_equal_jax(bits, mode, dtype):
    w = _weight((577, 40), seed=9)
    j = JQ.quantize_weight(jnp.asarray(w), bits, mode)
    p = _carry(j)
    assert isinstance(p, Q.QuantizedWeight) and p.scale.dtype == torch.float32
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(JQ.dequantize_weight(j, jdt).astype(jnp.float32))
    got = Q.dequantize_weight(p, dtype)
    assert got.dtype == dtype and got.shape == (577, 40)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # and quantized again by the port, the same values
    err = np.abs(got.float().numpy() - w).max()
    assert err <= np.abs(w).max() / (7 if bits == 4 else 127)


def test_pack_and_unpack_round_trip_odd_rows():
    rng = np.random.default_rng(1)
    idx = torch.from_numpy(rng.integers(0, 16, (7, 5)).astype(np.uint8))
    packed = Q._pack_uint4(idx)
    assert packed.dtype == torch.int8 and packed.shape == (4, 5)
    np.testing.assert_array_equal(Q._unpack_uint4(packed)[:7].numpy(),
                                  idx.numpy())
    q = torch.from_numpy(rng.integers(-7, 8, (9, 3)).astype(np.int8))
    np.testing.assert_array_equal(
        Q._unpack_int4(Q._pack_int4(q), 9).numpy(), q.numpy())
    np.testing.assert_array_equal(
        Q._pack_int4(q).numpy(),
        np.asarray(JQ._pack_int4(jnp.asarray(q.numpy()))))


def _jax_quantized(jparams, bits, mode):
    jq = JQ.quantize_params(jparams, bits, mode=mode)
    return jq, from_jax_params(_np_tree(jq), "cpu")


@pytest.mark.parametrize("bits,mode", MODES)
def test_quantize_params_on_the_tiny_family_match_jax(tiny, bits, mode):
    (jparams, jarch, _, _), (params, _, _, _) = tiny
    jq = JQ.quantize_params(jparams, bits, mode=mode)
    q = Q.quantize_params(params, bits, mode=mode)

    def kinds(tree):
        flat = []

        def visit(t, path=()):
            if isinstance(t, dict):
                for k in sorted(t):
                    visit(t[k], path + (k,))
            elif isinstance(t, list):
                for i, v in enumerate(t):
                    visit(v, path + (i,))
            else:
                flat.append((path, type(t).__name__ == "QuantizedWeight"))
        visit(tree)
        return flat

    assert kinds(q) == kinds(jq)
    assert sum(k for _, k in kinds(q)) > 0
    assert not isinstance(q["text"]["embed"], Q.QuantizedWeight)
    assert Q.quantized_bytes(q) == JQ.quantized_bytes(jq)
    assert Q.quantized_bytes(params) == JQ.quantized_bytes(jparams)
    assert Q.quantized_bytes(q) < Q.quantized_bytes(params)
    assert Q.quantized_leaves(q) and not Q.quantized_leaves(params)
    # dequantize_params of JAX's bytes, carried across, equals JAX's
    got = Q.dequantize_params(from_jax_params(_np_tree(jq), "cpu"))
    want = _np_tree(JQ.dequantize_params(jq))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), b)
    moved = Q.tree_to(q, "cpu")
    assert Q.quantized_bytes(moved) == Q.quantized_bytes(q)


def test_encode_over_a_quantized_tree_matches_jax(tiny):
    (jparams, jarch, jtok, jtmpl), (_, arch, tok, tmpl) = tiny
    jq, q = _jax_quantized(jparams, 4, "nf4")
    ids, mask = jtok.pad_batch([jtok.encode(c) for c in CAPTIONS[:3]],
                               pad_to_multiple=16)
    px = np.random.default_rng(3).random((3, 32, 32, 3), np.float32)
    img = jtok.encode(jtmpl.expand_image(jtmpl.image_prompt(),
                                         jarch.num_image_tokens))
    iids, imask = jtok.pad_batch([img] * 3, pad_to_multiple=16)
    for i, m, pix in ((ids, mask, None), (iids, imask, px)):
        jd, jl = jmllm.encode(jq, jarch, jnp.asarray(i), jnp.asarray(m),
                              None if pix is None else jnp.asarray(pix))
        d, lg = mllm.encode(q, arch, torch.from_numpy(np.asarray(i)),
                            torch.from_numpy(np.asarray(m)),
                            None if pix is None else torch.from_numpy(pix))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    # the quantized model is another model than the f32 one
    d0, _ = mllm.encode(from_jax_params(_np_tree(jparams), "cpu"), arch,
                        torch.from_numpy(np.asarray(ids)),
                        torch.from_numpy(np.asarray(mask)))
    d1, _ = mllm.encode(q, arch, torch.from_numpy(np.asarray(ids)),
                        torch.from_numpy(np.asarray(mask)))
    assert float((d0 - d1).abs().max()) > 1e-4


def test_bf16_quantized_tree_computes_in_the_jax_dtypes():
    """A bf16 model with a quantized base: ``QuantizedWeight.dtype`` is f32
    in both packages, so the vision tower (which casts pixels to the patch
    embedding's dtype) runs in f32 in both; the decoder's dense layers
    dequantize into the bf16 activations in both."""
    jparams, jarch, jtok, jtmpl = j_build_model(
        JModelConfig(family=JFamily.TINY_DEBUG, dtype="bfloat16", **TINY),
        captions=CAPTIONS)
    jq = JQ.quantize_params(jparams, 4, mode="nf4")
    f32 = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) if x.dtype == jnp.bfloat16
        else np.asarray(x), jq)
    q = from_jax_params(f32, "cpu")

    def bf16(t):
        if isinstance(t, dict):
            return {k: bf16(v) for k, v in t.items()}
        if isinstance(t, list):
            return [bf16(v) for v in t]
        return t.to(torch.bfloat16) if isinstance(t, torch.Tensor) and \
            t.is_floating_point() else t

    q = bf16(q)
    arch = get_family_spec(ModelFamily.TINY_DEBUG,
                           ModelConfig(dtype="bfloat16", **TINY)).arch
    px = np.random.default_rng(4).random((2, 32, 32, 3), np.float32)
    jfeat = jvit.apply(jq["vision"], jnp.asarray(px), jarch.vision)
    feat = vit.apply(q["vision"], torch.from_numpy(px), arch.vision)
    assert jfeat.dtype == jnp.float32 and feat.dtype == torch.float32
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), **BF16_TOL)
    img = jtok.encode(jtmpl.expand_image(jtmpl.image_prompt(),
                                         jarch.num_image_tokens))
    ids, mask = jtok.pad_batch([img] * 2, pad_to_multiple=16)
    jh = jmllm.forward_hidden(jq, jarch, jnp.asarray(ids), jnp.asarray(mask),
                              jnp.asarray(px))
    h = mllm.forward_hidden(q, arch, torch.from_numpy(np.asarray(ids)),
                            torch.from_numpy(np.asarray(mask)),
                            torch.from_numpy(px))
    assert jh.dtype == jnp.bfloat16 and h.dtype == torch.bfloat16
    np.testing.assert_allclose(h.float().numpy(),
                               np.asarray(jh.astype(jnp.float32)),
                               **BF16_TOL)


@pytest.mark.parametrize("bits,mode", [(4, "nf4"), (4, "linear")])
def test_qlora_steps_match_the_jax_trainer(tiny, bits, mode):
    (jparams, jarch, jtok, jtmpl), (_, arch, _, _) = tiny
    jq, q = _jax_quantized(jparams, bits, mode)
    kw = dict(learning_rate=3e-3, tau=0.1, lora_rank=4, lora_alpha=8,
              lora_dropout=0.0, shard_optimizer_state=False, load_kbit=bits)
    jad, ad = _adapters(jparams, jarch)
    jt = jtrainer.ContrastiveTrainer(jq, jarch, jad, JTrainConfig(**kw))
    pt = ContrastiveTrainer(q, arch, from_jax_lora(ad, "cpu"),
                            TrainConfig(**kw), device="cpu")
    base = [x.clone() for x in lora.tree_leaves(q)]
    jcol = jtrainer.make_collator(jtok, jtmpl, jarch)
    jex = _examples(True)
    for rows in ([0, 1, 2, 3], [4, 5, 6, 7], [2, 5, 0, 7]):
        jb = jcol([jex[r] for r in rows])
        np.testing.assert_allclose(pt.train_on_batch(_port_batch(jb)),
                                   jt.train_on_batch(jb), **TOL)
    for g, r in zip(jax.tree_util.tree_leaves(pt.adapters),
                    jax.tree_util.tree_leaves(jt.adapters)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   **STEP_TOL)
    # the base stays quantized and untouched, and never needs a gradient
    assert Q.quantized_leaves(pt.params)
    after = lora.tree_leaves(pt.params)
    assert all(torch.equal(a, b) for a, b in zip(after, base))
    assert not any(x.requires_grad for x in after)
    assert len(pt._trainable_leaves()) == len(pt.opt_state["mu"]) == \
        len(lora.tree_leaves(pt.adapters))


def test_full_finetune_and_merge_over_a_quantized_base_are_refused(tiny):
    (jparams, jarch, _, _), (_, arch, _, _) = tiny
    jq, q = _jax_quantized(jparams, 8, "linear")
    with pytest.raises(ValueError, match="k-bit") as err:
        ContrastiveTrainer(q, arch, {"text": {"blocks": []}},
                           TrainConfig(train_full=True), device="cpu")
    with pytest.raises(ValueError, match="k-bit") as jerr:
        jtrainer.ContrastiveTrainer(jq, jarch, None, JTrainConfig())
    assert str(err.value) == str(jerr.value)
    jad, ad = _adapters(jparams, jarch)
    with pytest.raises(TypeError, match="quantized") as jerr:
        jlora.merge_lora(jq, jad)
    with pytest.raises(TypeError, match="quantized") as err:
        lora.merge_lora(q, from_jax_lora(ad, "cpu"))
    assert str(err.value) == str(jerr.value)
    with pytest.raises(TypeError):
        L.merge_lora_into_dense(q["text"]["blocks"][0]["q"],
                                from_jax_lora(ad, "cpu")["text"]["blocks"]
                                [0]["q"])


def test_init_lora_reads_logical_shapes_from_a_quantized_tree(tiny):
    (jparams, jarch, _, _), (params, arch, _, _) = tiny
    jq, q = _jax_quantized(jparams, 4, "nf4")
    ad = lora.init_lora(torch.Generator().manual_seed(0), q, arch, rank=4,
                        train_vision=True, train_projector=True,
                        device="cpu")
    jad = jlora.init_lora(jax.random.PRNGKey(0), jq, jarch, rank=4,
                          train_vision=True, train_projector=True)
    for a, b in zip(jax.tree_util.tree_leaves(ad),
                    jax.tree_util.tree_leaves(jad)):
        assert tuple(a.shape) == tuple(b.shape)


@pytest.mark.parametrize("bits,fmt", [("4", "nf4"), ("8", "nf4")])
def test_train_cli_load_kbit_matches_the_jax_cli(data_root, tmp_path,  # noqa
                                                 monkeypatch, caplog, bits,
                                                 fmt):
    """``--load-kbit`` on ``tiny_debug``: both CLIs quantize the same f32
    weights (8 bits is linear whatever ``--quant-format`` says) and train
    the same adapters; the port's ``lora.pkl`` within STEP_TOL of JAX's."""
    built = {}
    real_j = jcli_train.build_model

    def j_build(cfg, captions=None, seed=0):
        built["jax"] = real_j(cfg, captions, seed)
        return built["jax"]

    flags = ("--load-kbit", bits, "--quant-format", fmt)
    monkeypatch.setattr(jcli_train, "build_model", j_build)
    jcli_train.main(_args(data_root, "tiny_debug", tmp_path / "jax", *flags))
    jparams, jarch = built["jax"][0], built["jax"][1]
    real = cli_train.build_model

    def build(cfg, captions=None, seed=0, device="cuda"):
        _, arch, tok, tmpl = real(cfg, captions, seed, device)
        return from_jax_params(_np_tree(jparams), device), arch, tok, tmpl

    def init_lora(gen, params, arch, rank, alpha, train_vision,
                  train_projector, device):
        assert Q.quantized_leaves(params)
        return from_jax_lora(_np_tree(jlora.init_lora(
            jax.random.PRNGKey(0), jparams, jarch, rank=rank, alpha=alpha)),
            device)

    monkeypatch.setattr(cli_train, "build_model", build)
    monkeypatch.setattr(cli_train.lora_lib, "init_lora", init_lora)
    args = cli_train.build_parser().parse_args(
        _args(data_root, "tiny_debug", tmp_path / "port", "--device", "cpu",
              *flags))
    with caplog.at_level("INFO"):
        path, trainer = cli_train.run(args)
    assert any(r.getMessage().startswith(f"kbit load: {bits}-bit")
               for r in caplog.records)
    mode = {q.mode for q in Q.quantized_leaves(trainer.params)}
    assert mode == ({"nf4"} if bits == "4" else {"linear"})
    with open(path, "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jax" / "lora.pkl", "rb") as f:
        want = _np_tree(pickle.load(f))
    _close(got, want)


@pytest.mark.parametrize("flag", ["--train-full", "--merge"])
def test_train_cli_load_kbit_usage_errors_match_jax(data_root, tmp_path,  # noqa
                                                    capsys, flag):
    for name, fn in (("jax", jcli_train.main), ("port", None)):
        argv = _args(data_root, "tiny_debug", tmp_path / name, "--load-kbit",
                     "4", flag)
        with pytest.raises(SystemExit) as exit_:
            if fn is not None:
                fn(argv)
            else:
                cli_train.run(cli_train.build_parser().parse_args(
                    argv + ["--device", "cpu"]))
        assert exit_.value.code == 2
        err = capsys.readouterr().err.splitlines()[-1]
        assert err.split("error: ")[1] == {
            "--train-full": "--load-kbit pairs with LoRA (QLoRA); "
                            "--train-full needs trainable fp weights",
            "--merge": "--merge cannot fold adapters into a quantized base; "
                       "serve adapters separately (--lora-path)"}[flag]


def test_quantized_weight_fields_match_jax():
    got = [f.name for f in dataclasses.fields(Q.QuantizedWeight)]
    want = [f.name for f in dataclasses.fields(JQ.QuantizedWeight)]
    assert got == want
    assert Q.NF4_CODE == JQ.NF4_CODE and Q.NF4_BLOCK == JQ.NF4_BLOCK
    assert RepsLoc.BEFORE_PAD.value == "before_pad"

"""PyTorch port, training the chat-template families against the JAX
package: ``make_collator`` and ``ContrastiveTrainer`` on InternVL2.5 (the
tiny arch of ``test_torch_internvl.py``: dynamic tiles through the chat
template) and Qwen2.5-VL (``TINY_QWEN_DEBUG``, a fixed grid, and the tiny
native-resolution arch of ``test_torch_qwen_vl.py``), the same seeded
images, weights and adapters in both packages (carried across with
``from_jax_params`` / ``from_jax_lora``), at ``lora_dropout=0`` (JAX draws
dropout masks from its own PRNG).

Tolerances: collated batches exact (token ids, masks and M-RoPE ids equal
as int arrays, tile stacks and patch tables byte-equal); the loss of every
step ``atol=rtol=1e-5`` and the adapters after three Adam steps
``atol=rtol=1e-4`` (f32 on the CPU; ``test_torch_train.py``'s STEP_TOL:
each step divides a gradient by its own running RMS). Refusals: the same
exception type as the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.configs import ModelConfig as JModelConfig
from mllm_sparse_retrieval_tpu.configs import ModelFamily as JFamily
from mllm_sparse_retrieval_tpu.configs import TrainConfig as JTrainConfig
from mllm_sparse_retrieval_tpu.data.karpathy import Example as JExample
from mllm_sparse_retrieval_tpu.models import build_model as j_build_model
from mllm_sparse_retrieval_tpu.models import internvl as jinternvl
from mllm_sparse_retrieval_tpu.models import lora as jlora
from mllm_sparse_retrieval_tpu.models import qwen_vl as jqwen
from mllm_sparse_retrieval_tpu.models import templates as jtemplates
from mllm_sparse_retrieval_tpu.train import trainer as jtrainer
from mllm_sparse_retrieval_tpu_torch.configs import (
    ModelConfig, ModelFamily, TrainConfig)
from mllm_sparse_retrieval_tpu_torch.data.karpathy import Example
from mllm_sparse_retrieval_tpu_torch.models import internvl, lora, templates
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import (
    from_jax_lora, from_jax_params)
from mllm_sparse_retrieval_tpu_torch.models.registry import get_family_spec
from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
    WordPieceLiteTokenizer)
from mllm_sparse_retrieval_tpu_torch.train.trainer import (
    ContrastiveTrainer, TrainBatch, make_collator)
from tests.test_torch_chat_templates import (
    CAPTIONS, SIZES, chat_tokenizers, images, noisy, port_arch)
from tests.test_torch_internvl import _jarch as _internvl_jarch
from tests.test_torch_qwen_vl import _jarch as _qwen_jarch
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(tiny_vocab_size=256, tiny_hidden_size=64, tiny_num_layers=2,
            tiny_num_heads=4, tiny_image_size=32, tiny_patch_size=16)
STEPS = ([0, 1, 2, 3], [4, 5, 6, 7], [2, 5, 0, 7])
FAMILIES = ("internvl", "qwen_native", "qwen_fixed")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _examples(jax_side):
    cls = JExample if jax_side else Example
    return [cls(c, f"/nonexistent/img_{k}.jpg", f"t{k}", f"i{k}")
            for k, c in enumerate(CAPTIONS)]


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """``(name, jax side, port side)``; each side is ``(params, arch,
    tokenizer, template, pixel_loader)``. The variable families load raw
    seeded images of ``SIZES`` (1-4 tiles, grids of 4-24 merge units)."""
    name = request.param
    raw = {f"i{k}": im for k, im in enumerate(
        images(5, SIZES + SIZES[:2]))}
    loader = (lambda e: raw[e.img_id])      # noqa: E731
    if name == "qwen_fixed":
        jparams, jarch, jtok, jtmpl = j_build_model(
            JModelConfig(family=JFamily.TINY_QWEN_DEBUG, dtype="float32",
                         **TINY), captions=CAPTIONS)
        tok = WordPieceLiteTokenizer.from_corpus_captions(
            CAPTIONS, vocab_size=TINY["tiny_vocab_size"])
        assert tok.get_vocab() == jtok.get_vocab()
        spec = get_family_spec(ModelFamily.TINY_QWEN_DEBUG,
                               ModelConfig(dtype="float32", **TINY))
        assert spec.arch == port_arch(jarch)
        jparams = noisy(jparams, 3)
        return name, (jparams, jarch, jtok, jtmpl, None), (
            from_jax_params(jparams, "cpu"), spec.arch, tok, spec.template,
            None)
    jtok, tok = chat_tokenizers()
    if name == "internvl":
        jarch = _internvl_jarch(
            image_token_id=jtok.special_ids["<IMG_CONTEXT>"])
        jparams = noisy(jinternvl.init_params(jax.random.PRNGKey(21),
                                              jarch), 22)
        tmpl = "INTERNVL2_5"
    else:
        jarch = _qwen_jarch(image_token_id=jtok.special_ids["<|image_pad|>"],
                            max_units=16)
        jparams = noisy(jqwen.init_params(jax.random.PRNGKey(23), jarch),
                        24)
        tmpl = "QWEN2_5_VL"
    return name, (jparams, jarch, jtok, getattr(jtemplates, tmpl), loader), (
        from_jax_params(jparams, "cpu"), port_arch(jarch), tok,
        getattr(templates, tmpl), loader)


def _port_batch(jb):
    def host(x):
        if isinstance(x, dict):
            return {k: np.asarray(v) for k, v in x.items()}
        return None if x is None else np.asarray(x)

    return TrainBatch(*(host(getattr(jb, f)) for f in (
        "text_ids", "text_mask", "image_ids", "image_mask", "pixels",
        "image_pos_ids")))


def _assert_batches_equal(b, jb):
    for f in ("text_ids", "text_mask", "image_ids", "image_mask"):
        np.testing.assert_array_equal(getattr(b, f),
                                      np.asarray(getattr(jb, f)))
    if isinstance(jb.pixels, dict):
        assert set(b.pixels) == set(jb.pixels)
        for k in b.pixels:
            assert b.pixels[k].tobytes() == np.asarray(
                jb.pixels[k]).tobytes(), k
    else:
        assert b.pixels.shape == np.shape(jb.pixels)
        assert np.asarray(b.pixels).tobytes() == np.asarray(
            jb.pixels).tobytes()
    if jb.image_pos_ids is None:
        assert b.image_pos_ids is None
    else:
        assert b.image_pos_ids.dtype.kind == "i"
        np.testing.assert_array_equal(b.image_pos_ids,
                                      np.asarray(jb.image_pos_ids))


def test_collator_matches_jax(family):
    """Token ids, masks, tile stacks or patch tables, and (Qwen) the
    ``[3, B, T]`` M-RoPE ids, exactly as the JAX collator makes them."""
    name, (_, jarch, jtok, jtmpl, jload), (_, arch, tok, tmpl, load) = family
    jcol = jtrainer.make_collator(jtok, jtmpl, jarch, pixel_loader=jload)
    col = make_collator(tok, tmpl, arch, pixel_loader=load)
    for lo, hi, tml in ((0, 4, None), (4, 8, 32)):
        jb = jcol(_examples(True)[lo:hi], tml)
        b = col(_examples(False)[lo:hi], tml)
        _assert_batches_equal(b, jb)
        if name == "internvl":     # [B, 5 tiles, 56, 56, 3], several counts
            assert b.pixels.shape == (4, 5, 56, 56, 3)
            assert b.image_pos_ids is None
        else:
            assert b.image_pos_ids.shape == (3,) + b.image_ids.shape
            # image slots carry 2-D positions: M-RoPE, not 1-D RoPE
            assert (b.image_pos_ids[1] != b.image_pos_ids[2]).any()


def _trainers(family, **over):
    _, (jparams, jarch, *_), (params, arch, *_) = family
    kw = dict(learning_rate=3e-3, tau=0.1, lora_rank=4, lora_alpha=8,
              lora_dropout=0.0, shard_optimizer_state=False) | over
    jad = _np(jlora.init_lora(jax.random.PRNGKey(0), jparams, jarch,
                              rank=4, alpha=8.0))
    jt = jtrainer.ContrastiveTrainer(
        jax.tree_util.tree_map(jnp.asarray, jparams), jarch,
        jax.tree_util.tree_map(jnp.asarray, jad), JTrainConfig(**kw))
    pt = ContrastiveTrainer(from_jax_params(jparams, "cpu"), arch,
                            from_jax_lora(jad, "cpu"), TrainConfig(**kw),
                            device="cpu")
    return jt, pt, jad


def _jax_batches(family):
    _, (_, jarch, jtok, jtmpl, jload), _ = family
    jcol = jtrainer.make_collator(jtok, jtmpl, jarch, pixel_loader=jload)
    jex = _examples(True)
    return [jcol([jex[r] for r in rows]) for rows in STEPS]


def _assert_adapters_close(pt, jt, jad):
    got = jax.tree_util.tree_leaves(pt.adapters)
    ref = jax.tree_util.tree_leaves(jt.adapters)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   **STEP_TOL)
    moved = [float(np.abs(g.detach().numpy() - a).max())
             for g, a in zip(got, jax.tree_util.tree_leaves(jad))]
    assert max(moved) > 1e-3


def test_trainer_matches_jax_trainer(family):
    """Three ``train_on_batch`` steps: every loss and the adapters after
    them; the image tower takes the M-RoPE ids (Qwen) and the tiles
    (InternVL) the collator made."""
    jt, pt, jad = _trainers(family)
    for jb in _jax_batches(family):
        jl = jt.train_on_batch(jb)
        pl = pt.train_on_batch(_port_batch(jb))
        np.testing.assert_allclose(pl, jl, **TOL)
    assert pt.step == jt.step == 3
    _assert_adapters_close(pt, jt, jad)


def test_grad_accum_matches_jax_or_refuses_as_jax(family):
    """``grad_accum_steps=2``: InternVL's tile stacks and Qwen's fixed-grid
    patches and M-RoPE ids split on their batch axes, as in the JAX
    trainer; Qwen's native-resolution pixels are a dict, which the JAX
    trainer's reshape cannot split: both raise ``AttributeError`` before
    any state changes."""
    name = family[0]
    jt, pt, jad = _trainers(family, grad_accum_steps=2)
    batches = _jax_batches(family)
    if name == "qwen_native":
        with pytest.raises(AttributeError):
            jt.train_on_batch(batches[0])
        with pytest.raises(AttributeError, match="grad_accum_steps=2"):
            pt.train_on_batch(_port_batch(batches[0]))
        assert pt.step == jt.step == 0
        return
    for jb in batches:
        np.testing.assert_allclose(pt.train_on_batch(_port_batch(jb)),
                                   jt.train_on_batch(jb), **TOL)
    _assert_adapters_close(pt, jt, jad)


@pytest.mark.parametrize("which", ["vision", "projector"])
def test_init_lora_on_the_chat_families_does_what_jax_does(family, which):
    """InternViT blocks name their projections q/k/v/proj/fc1/fc2 and
    Qwen's ViT qkv/proj, so ``train_vision`` raises ``KeyError`` in both
    packages; InternVL's ``mlp1`` projector (fc1/fc2) takes adapters, and
    Qwen has no ``projector`` entry (``KeyError``)."""
    _, (jparams, jarch, *_), (params, arch, *_) = family
    kw = {f"train_{which}": True}
    try:
        want = _np(jlora.init_lora(jax.random.PRNGKey(1), jparams, jarch,
                                   rank=2, **kw))
    except Exception as e:           # noqa: BLE001 - the type is compared
        with pytest.raises(type(e)):
            lora.init_lora(torch.Generator().manual_seed(1), params, arch,
                           rank=2, device="cpu", **kw)
        assert family[0] != "internvl" or which == "vision"
        return
    got = lora.init_lora(torch.Generator().manual_seed(1), params, arch,
                         rank=2, device="cpu", **kw)
    assert family[0] == "internvl" and which == "projector"
    assert jax.tree_util.tree_structure(want) == \
        jax.tree_util.tree_structure(got)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == w.shape and str(g.dtype) == \
            f"torch.{w.dtype}"


def test_frozen_vision_tower_builds_no_graph(family):
    """With only text adapters trainable, the vision tower's output carries
    no autograd graph: the tiles cost forward time only."""
    name, _, (params, arch, tok, tmpl, load) = family
    pt = ContrastiveTrainer(
        params, arch, lora.init_lora(torch.Generator().manual_seed(0),
                                     params, arch, rank=2, device="cpu"),
        TrainConfig(lr_schedule="constant"), device="cpu")
    batch = make_collator(tok, tmpl, arch, pixel_loader=load)(
        _examples(False)[:2])
    *_, pixels, pos = pt._to_device(batch, 0, 2)
    if name == "internvl":
        feats = internvl.image_features(pt.params, pixels.flatten(0, 1),
                                        arch)
        assert not feats.requires_grad and feats.grad_fn is None
    assert not any(x.requires_grad for x in
                   lora.tree_leaves(pt.params["vision"]))
    if name != "internvl":
        assert pos.shape == (3, 2, batch.image_ids.shape[1])

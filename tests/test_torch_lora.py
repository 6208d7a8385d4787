"""PyTorch port, LoRA: ``layers.dense`` with adapters, ``lora_init``,
``merge_lora_into_dense``, ``models/lora.py`` (init, merge, the adapter
pickle) and adapters threaded through ``llama.apply``, ``mllm.encode`` and
``api.encode_any``, against the JAX package on the same seeded inputs and on
weights and adapters carried across with ``from_jax_params`` /
``from_jax_lora``. Also ``mllm.encode`` / ``encode_any`` called positionally
in the JAX package's argument order, and LoRA dropout, which the JAX
package draws from its own PRNG and cannot be compared: its keep rate and
scaling, its determinism per seed, and remat giving the same values and
gradients as no remat with dropout on.

Adapters compared with JAX have random nonzero ``b`` (an initial ``b = 0``
makes every ``a`` gradient exactly 0).

Tolerances (f32 on the CPU): ``atol=rtol=1e-5`` on values, ``1e-4`` on
sparse logits (the LM head's long dot product) and on gradients with respect
to the adapters (a backward pass through the tower sums in yet other
orders). Remat against no remat, and a seed against itself: exact.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.configs import ModelConfig as JModelConfig
from mllm_sparse_retrieval_tpu.configs import RepsLoc as JRepsLoc
from mllm_sparse_retrieval_tpu.models import api as japi
from mllm_sparse_retrieval_tpu.models import layers as JL
from mllm_sparse_retrieval_tpu.models import llama as jllama
from mllm_sparse_retrieval_tpu.models import lora as jlora
from mllm_sparse_retrieval_tpu.models import mllm as jmllm
from mllm_sparse_retrieval_tpu.models.llama import LlamaConfig as JLlamaConfig
from mllm_sparse_retrieval_tpu.models.mllm import MLLMConfig as JMLLMConfig
from mllm_sparse_retrieval_tpu.models.registry import (
    tiny_debug_arch as j_tiny_arch)
from mllm_sparse_retrieval_tpu.models.vit import ViTConfig as JViTConfig
from mllm_sparse_retrieval_tpu_torch.configs import ModelConfig, RepsLoc
from mllm_sparse_retrieval_tpu_torch.models import api
from mllm_sparse_retrieval_tpu_torch.models import layers as L
from mllm_sparse_retrieval_tpu_torch.models import llama, lora, mllm
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import (
    from_jax_lora, from_jax_params)
from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
from mllm_sparse_retrieval_tpu_torch.models.mllm import MLLMConfig
from mllm_sparse_retrieval_tpu_torch.models.registry import tiny_debug_arch
from mllm_sparse_retrieval_tpu_torch.models.vit import ViTConfig
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(tiny_vocab_size=256, tiny_hidden_size=64, tiny_num_layers=2,
            tiny_num_heads=4)
VIT = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2,
           num_heads=4, feature_layer=-2)
TEXT = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=128, rope_theta=10000.0)
PINPOINTS = ((28, 56), (56, 28), (56, 56))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def fixed_model():
    jarch = j_tiny_arch(JModelConfig(dtype="float32", **TINY))
    arch = tiny_debug_arch(ModelConfig(dtype="float32", **TINY))
    jparams = jmllm.init_params(jax.random.PRNGKey(0), jarch, jnp.float32)
    return jarch, arch, jparams, from_jax_params(_np_tree(jparams), "cpu")


@pytest.fixture(scope="module")
def anyres_model():
    jarch = JMLLMConfig(vision=JViTConfig(**VIT), text=JLlamaConfig(**TEXT),
                        image_token_id=4, grid_pinpoints=PINPOINTS)
    arch = MLLMConfig(vision=ViTConfig(**VIT), text=LlamaConfig(**TEXT),
                      image_token_id=4, grid_pinpoints=PINPOINTS)
    jparams = jmllm.init_params(jax.random.PRNGKey(1), jarch, jnp.float32)
    return jarch, arch, jparams, from_jax_params(_np_tree(jparams), "cpu")


def _adapters(jparams, jarch, seed, vision=True, projector=True):
    """A JAX adapter tree with random nonzero ``b``, and its port copy."""
    tree = _np_tree(jlora.init_lora(jax.random.PRNGKey(seed), jparams, jarch,
                                    rank=4, alpha=8.0, train_vision=vision,
                                    train_projector=projector))
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, dict) and "b" in node:
            node["b"] = (0.1 * rng.normal(size=node["b"].shape)).astype(
                np.float32)
            return
        for child in (node.values() if isinstance(node, dict) else node):
            fill(child)

    fill(tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), from_jax_lora(tree,
                                                                    "cpu")


def _requires_grad(tree):
    return [x.requires_grad_() for x in jax.tree_util.tree_leaves(tree)]


# ---- layers ------------------------------------------------------------------

@pytest.mark.parametrize("bias", [False, True])
def test_dense_with_lora_matches_jax(bias):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 12)).astype(np.float32)
    p = {"w": rng.normal(size=(12, 7)).astype(np.float32)}
    if bias:
        p["b"] = rng.normal(size=(7,)).astype(np.float32)
    lo = {"a": rng.normal(size=(12, 3)).astype(np.float32),
          "b": rng.normal(size=(3, 7)).astype(np.float32),
          "scale": np.float32(8 / 3)}
    got = L.dense(_t(x), {k: _t(v) for k, v in p.items()},
                  {k: _t(v) for k, v in lo.items()})
    ref = JL.dense(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                   {k: jnp.asarray(v) for k, v in lo.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    base = L.dense(_t(x), {k: _t(v) for k, v in p.items()})
    assert not torch.allclose(got, base)


def test_merge_lora_into_dense_and_lora_init_match_jax():
    rng = np.random.default_rng(1)
    p = {"w": rng.normal(size=(12, 7)).astype(np.float32),
         "b": rng.normal(size=(7,)).astype(np.float32)}
    lo = {"a": rng.normal(size=(12, 3)).astype(np.float32),
          "b": rng.normal(size=(3, 7)).astype(np.float32),
          "scale": np.float32(2.0)}
    got = L.merge_lora_into_dense({k: _t(v) for k, v in p.items()},
                                  {k: _t(v) for k, v in lo.items()})
    ref = JL.merge_lora_into_dense(
        {k: jnp.asarray(v) for k, v in p.items()},
        {k: jnp.asarray(v) for k, v in lo.items()})
    assert set(got) == set(ref) == {"w", "b"}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **TOL)
    gen = torch.Generator().manual_seed(0)
    init = L.lora_init(gen, 256, 96, 8, 16.0, device="cpu")
    jinit = JL.lora_init(jax.random.PRNGKey(0), 256, 96, 8, 16.0)
    for k in ("a", "b", "scale"):
        assert tuple(init[k].shape) == jinit[k].shape
        assert str(init[k].dtype).split(".")[-1] == str(jinit[k].dtype)
    assert float(init["b"].abs().max()) == 0.0
    assert float(init["scale"]) == float(jinit["scale"]) == 2.0
    assert abs(float(init["a"].std()) * 8 - 1.0) < 0.05    # N(0, 1) / r


# ---- models/lora.py ----------------------------------------------------------

def _structure(tree):
    return jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), tree)


@pytest.mark.parametrize("vision", [False, True])
@pytest.mark.parametrize("projector", [False, True])
def test_init_lora_tree_matches_jax(fixed_model, vision, projector):
    jarch, arch, jparams, params = fixed_model
    gen = torch.Generator().manual_seed(0)
    got = lora.init_lora(gen, params, arch, 4, 8.0, train_vision=vision,
                         train_projector=projector, device="cpu")
    ref = jlora.init_lora(jax.random.PRNGKey(0), jparams, jarch, 4, 8.0,
                          train_vision=vision, train_projector=projector)
    assert _structure(got) == _structure(ref)
    assert lora.num_lora_params(got) == jlora.num_lora_params(ref)
    assert all(float(x.abs().max()) == 0.0 for x in
               jax.tree_util.tree_leaves(got) if x.dim() == 2
               and x.shape[0] == 4)                        # every b is 0


def test_merge_lora_matches_jax(fixed_model):
    jarch, arch, jparams, params = fixed_model
    jad, ad = _adapters(jparams, jarch, 2)
    got = lora.merge_lora(params, ad)
    ref = jlora.merge_lora(jparams, jad)
    for g, r in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    # inputs unchanged; the merged model encodes as the unmerged one does
    assert torch.equal(params["text"]["blocks"][0]["q"]["w"],
                       _t(jparams["text"]["blocks"][0]["q"]["w"]))
    ids = torch.randint(5, 256, (2, 16), generator=torch.Generator()
                        .manual_seed(0))
    mask = torch.ones((2, 16), dtype=torch.int32)
    _, d1 = mllm.encode(got, arch, ids, mask)
    _, d2 = mllm.encode(params, arch, ids, mask, None, RepsLoc.BEFORE_PAD, ad)
    np.testing.assert_allclose(d1.detach().numpy(), d2.detach().numpy(),
                               atol=1e-4, rtol=1e-4)


def test_lora_pickles_load_in_either_package(fixed_model, tmp_path):
    jarch, arch, jparams, params = fixed_model
    jad, ad = _adapters(jparams, jarch, 3)
    jlora.save_lora(jad, str(tmp_path / "jax.pkl"))
    got = lora.load_lora(str(tmp_path / "jax.pkl"), device="cpu")
    lora.save_lora(ad, str(tmp_path / "port.pkl"))
    back = jlora.load_lora(str(tmp_path / "port.pkl"))
    with open(tmp_path / "port.pkl", "rb") as f:
        raw = pickle.load(f)
    assert all(isinstance(x, np.ndarray)
               for x in jax.tree_util.tree_leaves(raw))
    for g, b, r in zip(jax.tree_util.tree_leaves(got),
                       jax.tree_util.tree_leaves(back),
                       jax.tree_util.tree_leaves(jad)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(np.asarray(b), np.asarray(r))
    assert _structure(got) == _structure(ad)
    with pytest.raises(KeyError, match="adapter tree"):
        from_jax_lora({"blocks": []}, "cpu")


# ---- the towers with adapters --------------------------------------------------

def _text_batch(seed, vocab, t=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, size=(3, t)).astype(np.int32)
    mask = np.ones((3, t), np.int32)
    mask[1, 11:] = 0
    mask[2, 5:] = 0
    return ids, mask


@pytest.mark.parametrize("loc", ["before_pad", "after_pad"])
def test_encode_takes_the_jax_argument_order(fixed_model, loc):
    """``mllm.encode`` and ``encode_any`` called positionally, exactly as
    the JAX package calls them (``api.py`` calls ``mllm.encode`` so)."""
    jarch, arch, jparams, params = fixed_model
    jad, ad = _adapters(jparams, jarch, 4)
    ids, mask = _text_batch(4, 256)
    px = np.random.default_rng(5).normal(size=(3, 64, 64, 3)).astype(
        np.float32)
    n_img = arch.num_image_tokens
    img_ids = np.concatenate([ids[:, :2], np.full((3, n_img), 4, np.int32),
                              ids[:, 2:]], axis=1)
    img_mask = np.concatenate([np.ones((3, n_img), np.int32), mask], axis=1)
    with torch.no_grad():
        s1, d1 = mllm.encode(params, arch, _t(img_ids).long(), _t(img_mask),
                             _t(px), RepsLoc(loc), ad, False, True)
        s2, d2 = api.encode_any(params, arch, _t(ids).long(), _t(mask), None,
                                RepsLoc(loc), ad, None, False, True)
    j1 = jmllm.encode(jparams, jarch, jnp.asarray(img_ids),
                      jnp.asarray(img_mask), jnp.asarray(px), JRepsLoc(loc),
                      jad, False, True)
    j2 = japi.encode_any(jparams, jarch, jnp.asarray(ids), jnp.asarray(mask),
                         None, JRepsLoc(loc), jad, None, False, True)
    for (s, d), (js, jd) in (((s1, d1), j1), ((s2, d2), j2)):
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-4,
                                   rtol=1e-4)


def test_llama_apply_with_lora_values_and_grads_match_jax(fixed_model):
    jarch, arch, jparams, params = fixed_model
    jad, ad = _adapters(jparams, jarch, 6, vision=False, projector=False)
    rng = np.random.default_rng(6)
    emb = rng.normal(size=(3, 16, 64)).astype(np.float32)
    _, mask = _text_batch(6, 256)
    probe = rng.normal(size=(3, 16, 64)).astype(np.float32)
    leaves = _requires_grad(ad["text"])
    out = llama.apply(params["text"], _t(emb), _t(mask), arch.text,
                      ad["text"])
    (out * _t(probe)).sum().backward()

    def jfun(lt):
        h = jllama.apply(jparams["text"], jnp.asarray(emb), jnp.asarray(mask),
                         jarch.text, lt)
        return jnp.sum(h * probe), h

    (_, ref), jgrad = jax.value_and_grad(jfun, has_aux=True)(jad["text"])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    for x, g in zip(leaves, jax.tree_util.tree_leaves(jgrad)):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), **GRAD_TOL)


def _anyres_inputs(arch, seed):
    rng = np.random.default_rng(seed)
    spec = api.image_input_spec(arch)
    items = [spec.preprocess_example(rng.uniform(size=hw + (3,)).astype(
        np.float32)) for hw in ((64, 64), (40, 120))]
    vis = spec.batch_vision([i for i, _ in items])
    t = max(n for _, n in items) + 8
    ids = np.zeros((2, t), np.int32)
    mask = np.zeros((2, t), np.int32)
    for i, (_, n) in enumerate(items):
        row = [1, 20, 21] + [4] * n + list(rng.integers(5, 128, size=3))
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return ids, mask, vis


@pytest.mark.parametrize("family", ["fixed", "anyres"])
def test_encode_with_lora_values_and_grads_match_jax(fixed_model,
                                                     anyres_model, family):
    """Every adapter (text, vision, projector) through ``encode_any`` with
    pixels: the dense rep and its gradient with respect to each adapter."""
    model = fixed_model if family == "fixed" else anyres_model
    jarch, arch, jparams, params = model
    jad, ad = _adapters(jparams, jarch, 7)
    if family == "fixed":
        ids, mask = _text_batch(7, 256)
        n_img = arch.num_image_tokens
        ids = np.concatenate([ids[:, :2], np.full((3, n_img), 4, np.int32),
                              ids[:, 2:]], axis=1)
        mask = np.concatenate([np.ones((3, n_img), np.int32), mask], axis=1)
        px = np.random.default_rng(7).normal(size=(3, 64, 64, 3)).astype(
            np.float32)
        vis, jvis = _t(px), jnp.asarray(px)
    else:
        ids, mask, v = _anyres_inputs(arch, 7)
        vis = {k: _t(x) for k, x in v.items()}
        jvis = {k: jnp.asarray(x) for k, x in v.items()}
    probe = np.random.default_rng(8).normal(
        size=(ids.shape[0], arch.text.hidden_size)).astype(np.float32)
    leaves = _requires_grad(ad)
    _, dense = api.encode_any(params, arch, _t(ids).long(), _t(mask), vis,
                              RepsLoc.BEFORE_PAD, ad)
    (dense * _t(probe)).sum().backward()

    def jfun(lt):
        _, d = japi.encode_any(jparams, jarch, jnp.asarray(ids),
                               jnp.asarray(mask), jvis, JRepsLoc.BEFORE_PAD,
                               lt)
        return jnp.sum(d * probe), d

    (_, ref), jgrad = jax.value_and_grad(jfun, has_aux=True)(jad)
    np.testing.assert_allclose(dense.detach().numpy(), np.asarray(ref), **TOL)
    jleaves = jax.tree_util.tree_leaves(jgrad)
    assert len(jleaves) == len(leaves)
    for x, g in zip(leaves, jleaves):
        # the last ViT block's adapters reach no output (feature_layer=-2):
        # no gradient here, zeros there
        got = np.zeros(x.shape, np.float32) if x.grad is None \
            else x.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(g), **GRAD_TOL)
    assert any(x.grad is not None and float(x.grad.abs().max()) > 0
               for x in jax.tree_util.tree_leaves(ad["vision"]))


# ---- dropout and remat ---------------------------------------------------------

def test_lora_dropout_keep_rate_scaling_and_determinism():
    rng = np.random.default_rng(9)
    x = _t(rng.normal(size=(4, 64, 32)).astype(np.float32))
    p = {"w": _t(rng.normal(size=(32, 16)).astype(np.float32))}
    eye = {"a": torch.eye(32), "b": torch.eye(32)[:, :16].clone(),
           "scale": torch.tensor(1.0)}
    base = L.dense(x, p)
    drop = 0.25

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return L.dense(x, p, eye, gen, drop) - base   # the adapter path

    adapter = run(0)
    kept = adapter != 0
    share = float(kept.float().mean())
    n = kept.numel()
    assert abs(share - (1 - drop)) < 5 * np.sqrt(drop * (1 - drop) / n)
    np.testing.assert_allclose(adapter[kept].numpy(),
                               (x[..., :16][kept] / (1 - drop)).numpy(),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(run(0), adapter)           # a seed is a mask
    assert not torch.equal(run(1), adapter)
    np.testing.assert_allclose(                   # no generator: no dropout
        (L.dense(x, p, eye, None, drop) - base).numpy(), x[..., :16].numpy(),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_remat_equals_no_remat(fixed_model, dropout):
    jarch, arch, jparams, params = fixed_model
    _, ad = _adapters(jparams, jarch, 10, vision=False, projector=False)
    ids, mask = _text_batch(10, 256)
    probe = _t(np.random.default_rng(10).normal(size=(3, 64)).astype(
        np.float32))
    results = []
    for remat in (False, True):
        leaves = _requires_grad(ad)
        for x in leaves:
            x.grad = None
        _, dense = api.encode_any(params, arch, _t(ids).long(), _t(mask),
                                  None, RepsLoc.BEFORE_PAD, ad, remat=remat,
                                  lora_seed=77, lora_dropout=dropout)
        (dense * probe).sum().backward()
        results.append((dense.detach(), [x.grad.clone() for x in leaves]))
    (d0, g0), (d1, g1) = results
    assert torch.equal(d0, d1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_dropout_seeds_fold_per_block_and_site(fixed_model):
    jarch, arch, jparams, params = fixed_model
    _, ad = _adapters(jparams, jarch, 11, vision=False, projector=False)
    ids, mask = _text_batch(11, 256)
    with torch.no_grad():
        def enc(**kw):
            return api.encode_any(params, arch, _t(ids).long(), _t(mask),
                                  None, RepsLoc.BEFORE_PAD, ad, **kw)[1]
        plain = enc()
        a = enc(lora_seed=5, lora_dropout=0.2)
        assert torch.equal(a, enc(lora_seed=5, lora_dropout=0.2))
        assert not torch.equal(a, enc(lora_seed=6, lora_dropout=0.2))
        assert not torch.equal(a, plain)
        # no dropout without a seed, and a seed without dropout is a no-op
        assert torch.equal(enc(lora_dropout=0.2), plain)
        assert torch.equal(enc(lora_seed=5), plain)
    seeds = {L.fold_seed(L.fold_seed(5, blk), site)
             for blk in range(32) for site in range(7)}
    assert len(seeds) == 32 * 7
    assert all(0 <= s < 2 ** 63 for s in seeds)

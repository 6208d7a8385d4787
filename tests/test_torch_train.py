"""PyTorch port, training: ``TrainConfig``, ``info_nce_loss``, the default
pixel loaders, ``make_collator`` and ``ContrastiveTrainer`` against the JAX
package's on the same seeded examples, weights and adapters (carried across
with ``from_jax_params`` / ``from_jax_lora``), at ``lora_dropout=0`` (JAX
draws dropout masks from its own PRNG). Then what only the port can check
against itself, with dropout on: checkpoint resume and remat replay a run
exactly. Then the overfit check the JAX package's own training test makes,
the served encoder with unmerged adapters against the JAX encoder, and the
asynchronous steps: ``train()``'s histories and sync schedule against the
JAX trainer's (last section).

Tolerances (f32 on the CPU): ``atol=rtol=1e-5`` on the loss and its
gradients, and on every loss of a multi-step run; ``atol=rtol=1e-4`` on the
adapters after several Adam steps (each step divides a gradient by its own
running RMS, which turns ulp-level differences in small gradient elements
into larger relative ones). Collated batches, loaders, step counts: exact.
Resume and remat against a straight run: exact.
"""

import builtins
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.configs import ModelConfig as JModelConfig
from mllm_sparse_retrieval_tpu.configs import ModelFamily as JFamily
from mllm_sparse_retrieval_tpu.configs import SparseConfig as JSparseConfig
from mllm_sparse_retrieval_tpu.configs import TrainConfig as JTrainConfig
from mllm_sparse_retrieval_tpu.data.karpathy import Example as JExample
from mllm_sparse_retrieval_tpu.models import build_model as j_build_model
from mllm_sparse_retrieval_tpu.models import lora as jlora
from mllm_sparse_retrieval_tpu.models import quantization as jquantization
from mllm_sparse_retrieval_tpu.models.llama import LlamaConfig as JLlamaConfig
from mllm_sparse_retrieval_tpu.models.mllm import MLLMConfig as JMLLMConfig
from mllm_sparse_retrieval_tpu.models.vit import ViTConfig as JViTConfig
from mllm_sparse_retrieval_tpu.pipelines import encode as jencode
from mllm_sparse_retrieval_tpu.serving import OnlineQueryEncoder as JEncoder
from mllm_sparse_retrieval_tpu.train import contrastive as jcontrastive
from mllm_sparse_retrieval_tpu.train import trainer as jtrainer
from mllm_sparse_retrieval_tpu_torch.configs import (
    ModelConfig, ModelFamily, RepsLoc, SparseConfig, TrainConfig)
from mllm_sparse_retrieval_tpu_torch.data.karpathy import Example
from mllm_sparse_retrieval_tpu_torch.models import lora, mllm
from mllm_sparse_retrieval_tpu_torch.models import templates
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import (
    from_jax_lora, from_jax_params)
from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
from mllm_sparse_retrieval_tpu_torch.models.mllm import MLLMConfig
from mllm_sparse_retrieval_tpu_torch.models.quantization import (
    quantize_params)
from mllm_sparse_retrieval_tpu_torch.models.registry import get_family_spec
from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
    WordPieceLiteTokenizer)
from mllm_sparse_retrieval_tpu_torch.models.vit import ViTConfig
from mllm_sparse_retrieval_tpu_torch.parallel import Sharded, make_mesh
from mllm_sparse_retrieval_tpu_torch.pipelines import encode as pencode
from mllm_sparse_retrieval_tpu_torch.serving import OnlineQueryEncoder
from mllm_sparse_retrieval_tpu_torch.train import contrastive
from mllm_sparse_retrieval_tpu_torch.train import trainer as trainer_mod
from mllm_sparse_retrieval_tpu_torch.train.trainer import (
    ContrastiveTrainer, TrainBatch, make_collator)
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
CAPTIONS = [
    "a red car parked on the street",
    "two dogs running through tall grass",
    "a man surfing a large ocean wave",
    "a plate of pasta with tomato sauce",
    "children playing soccer in a park",
    "a snowy mountain under a clear sky",
    "a woman reading a book in a cafe",
    "a train crossing a steel bridge",
]
TINY = dict(tiny_vocab_size=512, tiny_hidden_size=64, tiny_num_layers=2,
            tiny_num_heads=4, tiny_image_size=32, tiny_patch_size=16)
VIT = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2,
           num_heads=4, feature_layer=-2)
TEXT = dict(vocab_size=512, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=128, rope_theta=10000.0)
PINPOINTS = ((28, 56), (56, 28), (56, 56))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _examples(jax_side):
    cls = JExample if jax_side else Example
    return [cls(c, f"/nonexistent/img_{k}.jpg", f"t{k}", f"i{k}")
            for k, c in enumerate(CAPTIONS)]


@pytest.fixture(scope="module")
def tiny():
    """The JAX training test's tiny setup and the port's copy of it."""
    jparams, jarch, jtok, jtmpl = j_build_model(
        JModelConfig(family=JFamily.TINY_DEBUG, dtype="float32", **TINY),
        captions=CAPTIONS)
    tok = WordPieceLiteTokenizer.from_corpus_captions(
        CAPTIONS, vocab_size=TINY["tiny_vocab_size"])
    assert tok.get_vocab() == jtok.get_vocab()
    spec = get_family_spec(ModelFamily.TINY_DEBUG,
                           ModelConfig(dtype="float32", **TINY))
    params = from_jax_params(_np_tree(jparams), "cpu")
    return (jparams, jarch, jtok, jtmpl), (params, spec.arch, tok,
                                           spec.template)


def _anyres_pair():
    jarch = JMLLMConfig(vision=JViTConfig(**VIT), text=JLlamaConfig(**TEXT),
                        image_token_id=4, grid_pinpoints=PINPOINTS)
    arch = MLLMConfig(vision=ViTConfig(**VIT), text=LlamaConfig(**TEXT),
                      image_token_id=4, grid_pinpoints=PINPOINTS)
    return jarch, arch


def _adapters(jparams, jarch, seed=0, projector=True):
    tree = _np_tree(jlora.init_lora(jax.random.PRNGKey(seed), jparams, jarch,
                                    rank=4, alpha=8.0,
                                    train_projector=projector))
    return jax.tree_util.tree_map(jnp.asarray, tree), tree


def _port_batch(jbatch):
    pixels = jbatch.pixels
    if isinstance(pixels, dict):
        pixels = {k: np.asarray(v) for k, v in pixels.items()}
    return TrainBatch(*(np.asarray(x) for x in (
        jbatch.text_ids, jbatch.text_mask, jbatch.image_ids,
        jbatch.image_mask)), np.asarray(pixels) if not isinstance(
            pixels, dict) else pixels)


# ---- config, loss, loaders, collator -----------------------------------------

def test_train_config_matches_jax():
    got = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JTrainConfig)}
    assert got == ref
    assert ContrastiveTrainer.total_train_steps(8, 3, 5) == \
        jtrainer.ContrastiveTrainer.total_train_steps(8, 3, 5) == 10
    for n, b, e in ((7, 8, 3), (16, 8, 2), (17, 4, 1), (0, 4, 2)):
        assert ContrastiveTrainer.total_train_steps(n, b, e) == \
            jtrainer.ContrastiveTrainer.total_train_steps(n, b, e)


def test_info_nce_loss_and_grads_match_jax():
    rng = np.random.default_rng(0)
    t, i = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(2))
    tt, it = (torch.from_numpy(x).requires_grad_() for x in (t, i))
    loss = contrastive.info_nce_loss(tt, it, 0.05)
    loss.backward()
    jl, (jgt, jgi) = jax.value_and_grad(
        lambda a, b: jcontrastive.info_nce_loss(a, b, 0.05), argnums=(0, 1))(
            jnp.asarray(t), jnp.asarray(i))
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgt), **TOL)
    np.testing.assert_allclose(it.grad.numpy(), np.asarray(jgi), **TOL)
    assert float(contrastive.info_nce_loss(torch.eye(4, 8), torch.eye(4, 8),
                                           0.05)) < 0.01


def test_default_loaders_match_jax(tmp_path):
    ex, jex = _examples(False)[3], _examples(True)[3]
    np.testing.assert_array_equal(pencode.default_pixel_loader(32)(ex),
                                  jencode.default_pixel_loader(32)(jex))
    np.testing.assert_array_equal(pencode.default_raw_image_loader()(ex),
                                  jencode.default_raw_image_loader()(jex))
    np.testing.assert_array_equal(
        pencode.default_raw_image_loader((50, 70))(ex),
        jencode.default_raw_image_loader((50, 70))(jex))
    real = tmp_path / "img.jpg"
    real.write_bytes(b"not an image")
    for loader in (pencode.default_pixel_loader(32),
                   pencode.default_raw_image_loader()):
        with pytest.raises(ValueError, match="img.jpg: not a JPEG or PNG"):
            loader(Example("x", str(real), "t", "i"))


@pytest.mark.parametrize("family", ["fixed", "anyres"])
def test_make_collator_matches_jax(tiny, family):
    (_, jarch, jtok, jtmpl), (_, arch, tok, tmpl) = tiny
    if family == "anyres":
        jarch, arch = _anyres_pair()
        tmpl, jtmpl = templates.TINY, jtmpl
    jcol = jtrainer.make_collator(jtok, jtmpl, jarch)
    col = make_collator(tok, tmpl, arch)
    for lo, hi, tml in ((0, 4, None), (4, 8, 32)):
        jb = jcol(_examples(True)[lo:hi], tml)
        b = col(_examples(False)[lo:hi], tml)
        for f in ("text_ids", "text_mask", "image_ids", "image_mask"):
            np.testing.assert_array_equal(getattr(b, f),
                                          np.asarray(getattr(jb, f)))
        if family == "anyres":
            assert set(b.pixels) == set(jb.pixels)
            for k in b.pixels:
                np.testing.assert_array_equal(b.pixels[k],
                                              np.asarray(jb.pixels[k]))
        else:
            np.testing.assert_array_equal(b.pixels, np.asarray(jb.pixels))
        assert b.image_pos_ids is None and jb.image_pos_ids is None


# ---- the trainer against the JAX trainer ---------------------------------------

CASES = {
    "constant": dict(),
    "linear_warmup": dict(lr_schedule="linear", warmup_steps=2,
                          total_steps=5),
    "cosine": dict(lr_schedule="cosine", warmup_steps=1, total_steps=4),
    "weight_decay": dict(weight_decay=0.05),
    "clip": dict(max_grad_norm=0.05),
    "accum": dict(grad_accum_steps=2),
    "train_full": dict(train_full=True, learning_rate=1e-4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_matches_jax_trainer(tiny, case):
    (jparams, jarch, jtok, jtmpl), (params, arch, tok, tmpl) = tiny
    kw = dict(learning_rate=3e-3, tau=0.1, lora_rank=4, lora_alpha=8,
              lora_dropout=0.0, shard_optimizer_state=False) | CASES[case]
    jcfg, cfg = JTrainConfig(**kw), TrainConfig(**kw)
    jad, ad = _adapters(jparams, jarch)
    full = cfg.train_full
    jt = jtrainer.ContrastiveTrainer(jparams, jarch, None if full else jad,
                                     jcfg)
    mine = from_jax_params(_np_tree(jparams), "cpu")
    pt = ContrastiveTrainer(mine, arch, None if full else
                            from_jax_lora(ad, "cpu"), cfg, device="cpu")
    jcol = jtrainer.make_collator(jtok, jtmpl, jarch)
    jex = _examples(True)
    order = [[0, 1, 2, 3], [4, 5, 6, 7], [2, 5, 0, 7]]
    for rows in order + order[:1]:
        jb = jcol([jex[r] for r in rows])
        jl = jt.train_on_batch(jb)
        pl = pt.train_on_batch(_port_batch(jb))
        np.testing.assert_allclose(pl, jl, **TOL)
    assert pt.step == jt.step == 4
    got = pt.params if full else pt.adapters
    ref = jt.params if full else jt.adapters
    gl, rl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)
    assert len(gl) == len(rl)
    for g, r in zip(gl, rl):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   **STEP_TOL)
    if not full:
        moved = [float(np.abs(g.detach().numpy() - a).max()) for g, a in
                 zip(gl, jax.tree_util.tree_leaves(_np_tree(jad)))]
        assert max(moved) > 1e-3
    if case == "clip":        # the first step's gradient norm is clipped
        fresh = ContrastiveTrainer(
            from_jax_params(_np_tree(jparams), "cpu"), arch,
            from_jax_lora(ad, "cpu"), cfg, device="cpu")
        batch = _port_batch(jcol([jex[r] for r in order[0]]))
        loss = fresh._loss(*fresh._to_device(batch, 0, 4), 0)
        grads = torch.autograd.grad(loss, fresh._trainable_leaves(),
                                    allow_unused=True)
        norm = sum(float((g * g).sum()) for g in grads if g is not None)
        assert norm ** 0.5 > 2 * cfg.max_grad_norm


def test_trainer_learning_rates_match_optax(tiny):
    import optax

    (_, jarch, _, _), (params, arch, _, _) = tiny
    lr = 1e-3
    for sched, warm, total in (("linear", 3, 10), ("linear", 0, 7),
                               ("cosine", 2, 9), ("cosine", 0, 5),
                               ("constant", 4, 0), ("constant", 0, 0)):
        cfg = TrainConfig(learning_rate=lr, lr_schedule=sched,
                          warmup_steps=warm, total_steps=total)
        pt = ContrastiveTrainer(params, arch, {"text": {"blocks": []}}, cfg,
                                device="cpu")
        if sched == "linear":
            decay = optax.linear_schedule(lr, 0.0, max(total - warm, 1))
            ref = optax.join_schedules([optax.linear_schedule(
                0.0, lr, warm), decay], [warm]) if warm else decay
        elif sched == "cosine":
            ref = optax.warmup_cosine_decay_schedule(
                0.0, lr, warm, max(total, warm + 1))
        else:
            ref = optax.linear_schedule(0.0, lr, warm) if warm else \
                (lambda c: lr)
        for count in range(12):
            np.testing.assert_allclose(pt.learning_rate(count),
                                       float(ref(count)), rtol=1e-6,
                                       atol=1e-12)


def test_trainer_refuses_what_is_not_ported(tiny):
    (jparams, jarch, _, _), (params, arch, _, _) = tiny
    # meshes are ported (test_torch_mesh_train.py); a mesh of another kind
    # (the JAX package's) is refused
    with pytest.raises(TypeError, match="mesh"):
        ContrastiveTrainer(params, arch, None, TrainConfig(), mesh=object(),
                           device="cpu")
    # k-bit bases are ported (QLoRA, test_torch_quantization.py); a full
    # finetune over one is refused with the JAX trainer's ValueError
    qparams = quantize_params(params, 4, mode="nf4")
    with pytest.raises(ValueError, match="k-bit"):
        ContrastiveTrainer(qparams, arch, None, TrainConfig(load_kbit=4),
                           device="cpu")
    jq = jquantization.quantize_params(jparams, 4, mode="nf4")
    with pytest.raises(ValueError, match="k-bit"):
        jtrainer.ContrastiveTrainer(jq, jarch, None,
                                    JTrainConfig(load_kbit=4))
    with pytest.raises(ValueError, match="total_steps"):
        ContrastiveTrainer(params, arch, None,
                           TrainConfig(lr_schedule="cosine"), device="cpu")


# ---- the port against itself, dropout on -------------------------------------

def _port_run(tiny, tmp_path, steps, remat=False, resume_at=None):
    (jparams, jarch, jtok, jtmpl), (_, arch, tok, tmpl) = tiny
    cfg = TrainConfig(learning_rate=3e-3, tau=0.1, lora_rank=4, lora_alpha=8,
                      lora_dropout=0.2, remat=remat, seed=3)
    col = make_collator(tok, tmpl, arch)
    ex = _examples(False)
    batches = [col([ex[r] for r in rows]) for rows in
               ([0, 1, 2, 3], [4, 5, 6, 7], [2, 5, 0, 7], [1, 3, 6, 4])]

    def trainer():
        params = from_jax_params(_np_tree(jparams), "cpu")
        ad = from_jax_lora(_adapters(jparams, jarch, seed=1)[1], "cpu")
        return ContrastiveTrainer(params, arch, ad, cfg, device="cpu")

    pt = trainer()
    losses = []
    for i in range(steps):
        if i == resume_at:
            pt.save_checkpoint(str(tmp_path))
            pt = trainer()
            assert pt.restore_checkpoint(str(tmp_path)) == i
        losses.append(pt.train_on_batch(batches[i]))
    return losses, [x.detach().clone() for x in
                    jax.tree_util.tree_leaves(pt.adapters)]


def test_checkpoint_resume_replays_exactly(tiny, tmp_path):
    straight, ad = _port_run(tiny, tmp_path / "a", 4)
    resumed, ad2 = _port_run(tiny, tmp_path / "b", 4, resume_at=2)
    assert resumed == straight
    for a, b in zip(ad, ad2):
        assert torch.equal(a, b)
    assert (tmp_path / "b" / "latest").read_text() == "2"
    assert (tmp_path / "b" / "step_2" / "checkpoint.pt").exists()


def test_remat_replays_dropout_exactly(tiny, tmp_path):
    plain, ad = _port_run(tiny, tmp_path, 2)
    remat, ad2 = _port_run(tiny, tmp_path, 2, remat=True)
    assert remat == plain
    for a, b in zip(ad, ad2):
        assert torch.equal(a, b)


# ---- learning, serving ---------------------------------------------------------

def test_training_reduces_loss_and_learns_retrieval(tiny, tmp_path):
    _, (params, arch, tok, tmpl) = tiny
    cfg = TrainConfig(learning_rate=3e-3, tau=0.1, lora_rank=4, lora_alpha=8,
                      shard_optimizer_state=False)
    gen = torch.Generator().manual_seed(0)
    ad = lora.init_lora(gen, params, arch, rank=4, alpha=8.0,
                        train_projector=True, device="cpu")
    trainer = ContrastiveTrainer(params, arch, ad, cfg, device="cpu")
    col = make_collator(tok, tmpl, arch)
    ex = _examples(False)
    losses = trainer.train(ex, col, batch_size=8, num_epochs=40, logger=None,
                           checkpoint_dir=str(tmp_path))
    assert len(losses) == 40 and all(isinstance(x, float) for x in losses)
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    assert (tmp_path / "latest").read_text() == "40"
    merged = trainer.merged_params()
    batch = col(ex)
    with torch.inference_mode():
        _, t_emb = mllm.encode(merged, arch, torch.from_numpy(
            batch.text_ids).long(), torch.from_numpy(batch.text_mask))
        _, i_emb = mllm.encode(merged, arch, torch.from_numpy(
            batch.image_ids).long(), torch.from_numpy(batch.image_mask),
            torch.from_numpy(batch.pixels))
    sim = torch.nn.functional.normalize(t_emb, dim=-1) @ \
        torch.nn.functional.normalize(i_emb, dim=-1).T
    recall1 = float((sim.argmax(dim=1) == torch.arange(8)).float().mean())
    assert recall1 >= 0.75          # random baseline is 1/8


def test_online_encoder_with_unmerged_adapters_matches_jax(tiny):
    (jparams, jarch, jtok, jtmpl), (params, arch, tok, tmpl) = tiny
    jad, ad = _adapters(jparams, jarch, seed=2)
    rng = np.random.default_rng(2)
    for leaf in ("q", "down"):                     # adapters that do something
        for blk in ad["text"]["blocks"]:
            blk[leaf]["b"] = (0.2 * rng.normal(size=blk[leaf]["b"].shape)
                              ).astype(np.float32)
    jad = jax.tree_util.tree_map(jnp.asarray, ad)
    jenc = JEncoder(jparams, jarch, jtok, jtmpl, JSparseConfig(), lora=jad,
                    max_text_len=64)
    enc = OnlineQueryEncoder(params, arch, tok, tmpl, SparseConfig(),
                             lora=from_jax_lora(ad, "cpu"), max_text_len=64,
                             device="cpu")
    base = OnlineQueryEncoder(params, arch, tok, tmpl, SparseConfig(),
                              max_text_len=64, device="cpu")
    d, terms = enc.encode_texts(CAPTIONS[:3], pad_to=4)
    jd, jterms = jenc.encode_texts(CAPTIONS[:3], pad_to=4)
    np.testing.assert_allclose(d, jd, **TOL)
    for a, b in zip(terms, jterms):
        np.testing.assert_array_equal(a.token_ids, b.token_ids)
        np.testing.assert_array_equal(a.weights, b.weights)
    d0, _ = base.encode_texts(CAPTIONS[:3], pad_to=4)
    assert float(np.abs(d - d0).max()) > 1e-3
    img = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    di, ti = enc.encode_images([img], pad_to=2)
    jdi, jti = jenc.encode_images([img], pad_to=2)
    np.testing.assert_allclose(di, jdi, **TOL)
    np.testing.assert_array_equal(ti[0].token_ids, jti[0].token_ids)
    assert RepsLoc.BEFORE_PAD == enc.reps_loc


# ---- asynchronous steps against the JAX trainer's ------------------------------
#
# ``train_on_batch(batch, blocking=False)`` returns the loss as a device
# scalar and appends it; ``train()`` blocks only on the steps that log or
# checkpoint and on every ``sync_stride``-th step besides, and turns the
# history into floats in a ``finally``. The JAX side of the histories is
# ``test_training.py::test_async_stepping_matches_blocking``'s run. The
# schedule is compared step by step: the steps on which the port calls its
# sync methods (``_retire``, ``_drain``) against the steps on which the JAX
# trainer's ``train()`` passes ``blocking=True`` and calls
# ``jax.block_until_ready`` for the same arguments (its ``train_on_batch``
# stubbed to record them: the schedule is the epoch loop's). A stride below
# the step count comes from a smaller byte budget, patched in the test only:
# the port's ``SYNC_BUDGET_BYTES``, and the JAX trainer's clamp
# (``min(32, ...)``, read from its module's globals) at the same stride.
# Losses against the JAX trainer's at ``TOL``; the port's histories at
# different schedules exactly equal (the same operations run whether a step
# blocks or not).

ASYNC_KW = dict(learning_rate=3e-3, tau=0.1, lora_rank=4, lora_alpha=8,
                lora_dropout=0.0, shard_optimizer_state=False)
BATCH, EPOCHS = 4, 3                 # 8 examples: 2 steps an epoch, 6 steps


def _port(tiny, mesh=None, **cfg):
    (jparams, jarch, _, _), (params, arch, tok, tmpl) = tiny
    _, ad = _adapters(jparams, jarch)
    trainer = ContrastiveTrainer(params, arch, from_jax_lora(ad, "cpu"),
                                 TrainConfig(**(ASYNC_KW | cfg)), mesh=mesh,
                                 device="cpu")
    return trainer, make_collator(tok, tmpl, arch)


@pytest.fixture(scope="module")
def jax_history(tiny):
    """The JAX trainer's ``train()`` history (``logger=None``: every step
    asynchronous)."""
    (jparams, jarch, jtok, jtmpl), _ = tiny
    jad, _ = _adapters(jparams, jarch)
    jt = jtrainer.ContrastiveTrainer(jparams, jarch, jad,
                                     JTrainConfig(**ASYNC_KW))
    return jt.train(_examples(True), jtrainer.make_collator(jtok, jtmpl,
                                                            jarch),
                    batch_size=BATCH, num_epochs=EPOCHS, logger=None)


def _histories(tiny, mesh=None, **cfg):
    """The port's ``train()`` histories with ``log_every`` 1 and 5 and with
    ``logger=None``, and the last trainer."""
    out = []
    for log_every, logger in ((1, lambda m: None), (5, lambda m: None),
                              (1, None)):
        trainer, collate = _port(tiny, mesh, **cfg)
        hist = trainer.train(_examples(False), collate, batch_size=BATCH,
                             num_epochs=EPOCHS, log_every=log_every,
                             logger=logger)
        assert all(type(x) is float for x in hist)
        assert hist is trainer.loss_history
        out.append(hist)
    return out, trainer


def test_async_stepping_matches_blocking_and_jax(tiny, jax_history):
    (every, fifth, silent), _ = _histories(tiny)
    assert every == fifth == silent
    assert len(every) == EPOCHS * 8 // BATCH
    np.testing.assert_allclose(every, jax_history, **TOL)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_async_stepping_over_a_zero1_mesh(tiny, jax_history, shape):
    """A mesh of repeated CPU devices, ZeRO-1 on: the same histories at
    every schedule, and the unsharded JAX trainer's at ``TOL``."""
    mesh = make_mesh(*shape, devices=["cpu"] * 2)
    (every, fifth, silent), trainer = _histories(
        tiny, mesh, shard_optimizer_state=True)
    assert every == fifth == silent
    np.testing.assert_allclose(every, jax_history, **TOL)
    assert any(isinstance(m, Sharded) for m in trainer.opt_state["mu"])


def test_train_on_batch_without_blocking_returns_a_device_scalar(tiny):
    blocking, collate = _port(tiny)
    queued, _ = _port(tiny)
    batch = collate(_examples(False)[:BATCH])
    want = blocking.train_on_batch(batch)
    got = queued.train_on_batch(batch, blocking=False)
    assert type(want) is float
    assert isinstance(got, torch.Tensor) and got.shape == ()
    assert got.device == queued.device and not got.requires_grad
    assert queued.loss_history == [got] and queued.loss_history[0] is got
    assert queued.step == 1 and float(got) == want
    for a, b in zip(lora.tree_leaves(queued.adapters),
                    lora.tree_leaves(blocking.adapters)):
        assert torch.equal(a, b)


# ---- the sync schedule ---------------------------------------------------------

SCHEDULES = {
    "log_every_1": dict(log_every=1),
    "log_every_4_checkpoint_3": dict(log_every=4, checkpoint_every_steps=3),
    "silent": dict(logger=False),
    "silent_stride_2": dict(logger=False, stride=2),
    "log_every_5_stride_4": dict(log_every=5, stride=4),
    "log_every_0_checkpoint_2_stride_3": dict(
        log_every=0, checkpoint_every_steps=2, stride=3),
}
SCHEDULE_EPOCHS = 3                  # 6 steps


def _jax_schedule(tiny, monkeypatch, case, ckpt_dir):
    """The steps on which the JAX trainer's ``train()`` blocks a step, calls
    ``jax.block_until_ready`` and checkpoints, its steps stubbed."""
    (jparams, jarch, jtok, jtmpl), _ = tiny
    jad, _ = _adapters(jparams, jarch)
    every = case.get("checkpoint_every_steps", 0)
    jt = jtrainer.ContrastiveTrainer(jparams, jarch, jad, JTrainConfig(
        **ASYNC_KW, checkpoint_every_steps=every))
    blocked, drained, saved = [], [], []

    def step(batch, blocking=True):
        jt.step += 1
        if blocking:
            blocked.append(jt.step)
        loss = jnp.float32(1.0)
        return float(loss) if blocking else loss

    monkeypatch.setattr(jt, "train_on_batch", step)
    monkeypatch.setattr(jt, "save_checkpoint",
                        lambda d: saved.append(jt.step))
    monkeypatch.setattr(jtrainer.jax, "block_until_ready",
                        lambda x: drained.append(jt.step) or x)
    if "stride" in case:
        monkeypatch.setattr(jtrainer, "min", lambda a, b: builtins.min(
            case["stride"], b), raising=False)
    jt.train(_examples(True), lambda b, t=None: b, batch_size=BATCH,
             num_epochs=SCHEDULE_EPOCHS, log_every=case.get("log_every", 1),
             logger=None if case.get("logger") is False else lambda m: None,
             checkpoint_dir=ckpt_dir if every else None)
    monkeypatch.undo()
    return blocked, drained, saved


def _port_schedule(tiny, monkeypatch, case, ckpt_dir):
    every = case.get("checkpoint_every_steps", 0)
    trainer, collate = _port(tiny, checkpoint_every_steps=every)
    if "stride" in case:
        st = trainer.opt_state
        nbytes = sum(x.numel() * x.element_size() for x in
                     trainer._leaves() + st["mu"] + st["nu"])
        monkeypatch.setattr(trainer_mod, "SYNC_BUDGET_BYTES",
                            case["stride"] * nbytes + 1)
        assert trainer._sync_stride() == case["stride"]
    else:
        assert trainer._sync_stride() == 32
    blocked, drained, saved = [], [], []
    retire, drain, save = (trainer._retire, trainer._drain,
                           trainer.save_checkpoint)
    monkeypatch.setattr(trainer, "_retire", lambda loss: (
        blocked.append(trainer.step), retire(loss))[1])
    monkeypatch.setattr(trainer, "_drain", lambda: (
        drained.append(trainer.step), drain())[1])
    monkeypatch.setattr(trainer, "save_checkpoint", lambda d: (
        saved.append(trainer.step), save(d))[1])
    lines = []
    hist = trainer.train(
        _examples(False), collate, batch_size=BATCH,
        num_epochs=SCHEDULE_EPOCHS, log_every=case.get("log_every", 1),
        logger=None if case.get("logger") is False else lines.append,
        checkpoint_dir=ckpt_dir if every else None)
    monkeypatch.undo()
    assert all(type(x) is float for x in hist)
    return (blocked, drained, saved), lines, hist


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_sync_schedule_matches_jax(tiny, monkeypatch, tmp_path, name):
    case = SCHEDULES[name]
    want = _jax_schedule(tiny, monkeypatch, case, str(tmp_path / "jax"))
    got, lines, hist = _port_schedule(tiny, monkeypatch, case,
                                      str(tmp_path / "port"))
    assert got == want
    n = SCHEDULE_EPOCHS * 8 // BATCH
    log_every = case.get("log_every", 1)
    logged = [] if case.get("logger") is False or not log_every else [
        s for s in range(1, n + 1) if s % log_every == 0]
    assert lines == [f"epoch {(s - 1) // 2} step {s} loss {hist[s - 1]:.4f}"
                     for s in logged]
    if "stride" in case:           # the stride blocks a step of its own
        assert got[1]


class _Poisoned:
    """A queued loss whose step failed on the card: reading it raises."""

    def __float__(self):
        raise RuntimeError("the card lost this step")


def test_a_failing_collate_leaves_a_history_of_floats(tiny):
    trainer, collate = _port(tiny)
    calls = []

    def failing(batch, text_max_len=None):
        calls.append(1)
        if len(calls) == 4:
            raise ValueError("collate failed at step 3")
        return collate(batch, text_max_len)

    with pytest.raises(ValueError, match="collate failed at step 3"):
        trainer.train(_examples(False), failing, batch_size=BATCH,
                      num_epochs=EPOCHS, logger=None)
    assert trainer.step == 3 and len(trainer.loss_history) == 3
    assert all(type(x) is float and np.isfinite(x)
               for x in trainer.loss_history)
    # an element that cannot be read becomes NaN; the step's own exception
    # is the one that propagates
    trainer.loss_history.append(_Poisoned())
    with pytest.raises(ValueError, match="collate failed at step 3"):
        calls.clear()
        trainer.train(_examples(False), failing, batch_size=BATCH,
                      num_epochs=EPOCHS, logger=None)
    assert len(trainer.loss_history) == 7
    assert np.isnan(trainer.loss_history[3])
    assert all(type(x) is float for x in trainer.loss_history)

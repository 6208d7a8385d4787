"""PyTorch port, training over a mesh against the JAX package: the sharded
InfoNCE, and ``ContrastiveTrainer(mesh=...)`` against the JAX mesh trainer
over several ``train_on_batch`` steps (ZeRO-1 on and off, gradient
accumulation, ``gather_save_gradient=False``, a Qwen2.5-VL family with
M-RoPE ids, an FSDP full finetune). The JAX side runs on the conftest's
virtual CPU devices (a 2 x 2 mesh of four), the port on ``make_mesh(2, 2,
devices=["cpu"] * 4)``: the same two data shards, the same seeded weights,
adapters and examples (carried across with ``from_jax_params`` /
``from_jax_lora``), at ``lora_dropout=0`` (JAX draws dropout masks from its
own PRNG). Then what only the port can check against itself: a mesh step at
``lora_dropout=0.1`` against its unsharded step (fixed-grid pixels, and
LLaVA-NeXT's anyres dict of tile stacks split per key), and checkpoints
that move
between a mesh trainer and a trainer without one. Last, ``cli.train
--mesh --device cpu`` against the JAX CLI's ``--mesh``.

Tolerances (f32 on the CPU, ``test_torch_train.py``'s): ``atol=rtol=1e-5``
on the loss, its gradients and every loss of a run; ``atol=rtol=1e-4``
(STEP_TOL) on the trained leaves after several Adam steps. Spec counts,
checkpoint round trips and resumed runs: exact.

The ``qwen_mrope`` case holds its leaves on the port's own gradients.
Held to the JAX mesh trainer's leaves, one element moved with torch's
thread count: ``text.blocks[0].gate.b[3, 151]`` (the LoRA B of the first
decoder block's gate projection) landed 1.17e-4 from JAX's after the first
step at 1 and 4-7 threads, within it at 2, 3 and 8. Its first gradient
is -3.96e-7 in float64, where the leaf's median magnitude is 0.036. That
is a cancellation, so f32 rounding moves it by up to half its size: JAX f32
gives -4.02e-7, the port -6.35e-7 at 1 thread and -5.47e-7 at 8. The first
op whose output changes with the thread count is the Qwen2.5-VL ViT's
patch embedding, the ``[128, 1176] @ [1176, 64]`` matmul of a data shard's
two images: the CPU GEMM splits its 1,176-long reduction by thread count
at that shape. The unsharded batch's ``[256, 1176]`` product gives the same
bits at 1 and 8 threads. Gradient clipping (``max_grad_norm`` 1) scales the
element to a few times Adam's eps (1e-8), where the first update
``g / (|g| + eps)`` turns a 1e-7 difference in ``g`` into 0.04 of the
learning rate. The gradients themselves move by up to 2e-5 between
adapters 2.4e-7 apart (one f32 ulp of the LoRA ``scale`` leaves, after two
Adam steps in each package), so a gradient is compared only at the
adapters it was taken at. The case holds every gradient before Adam at ``TOL`` against the JAX
package's at the port's adapters of that step, and the leaves after the
steps at STEP_TOL against the JAX trainer's optimizer chain (its ``tx``)
run on those same gradients.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mllm_sparse_retrieval_tpu.configs import ModelConfig as JModelConfig
from mllm_sparse_retrieval_tpu.configs import ModelFamily as JFamily
from mllm_sparse_retrieval_tpu.configs import TrainConfig as JTrainConfig
from mllm_sparse_retrieval_tpu.models import build_model as j_build_model
from mllm_sparse_retrieval_tpu.models import lora as jlora
from mllm_sparse_retrieval_tpu.models.api import encode_any as j_encode_any
from mllm_sparse_retrieval_tpu.parallel import make_mesh as jmake_mesh
from mllm_sparse_retrieval_tpu.parallel.fsdp import (
    assert_fsdp_sharded as j_assert_fsdp)
from mllm_sparse_retrieval_tpu.train import contrastive as jcontrastive
from mllm_sparse_retrieval_tpu.train import trainer as jtrainer
from mllm_sparse_retrieval_tpu_torch.configs import (
    ModelConfig, ModelFamily, TrainConfig)
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import (
    from_jax_lora, from_jax_params)
from mllm_sparse_retrieval_tpu_torch.models.registry import get_family_spec
from mllm_sparse_retrieval_tpu_torch.models.tokenizer import (
    WordPieceLiteTokenizer)
from mllm_sparse_retrieval_tpu_torch.parallel import Sharded, make_mesh
from mllm_sparse_retrieval_tpu_torch.parallel.fsdp import (
    assert_fsdp_sharded)
from mllm_sparse_retrieval_tpu_torch.train import contrastive
from mllm_sparse_retrieval_tpu_torch.train.trainer import (
    ContrastiveTrainer, make_collator)
from tests.test_torch_chat_templates import noisy, port_arch
from tests.test_torch_train import (
    CAPTIONS, STEP_TOL, TINY, TOL, _adapters, _anyres_pair, _examples,
    _np_tree, _port_batch)
from tests.torch_threads import one_torch_thread  # noqa: F401

STEPS = ([0, 1, 2, 3], [4, 5, 6, 7], [2, 5, 0, 7])
TEXT_LEN = 32           # one caption length for every step: one JAX compile
QWEN_TINY = dict(tiny_vocab_size=256, tiny_hidden_size=64,
                 tiny_num_layers=2, tiny_num_heads=4, tiny_image_size=32,
                 tiny_patch_size=16)


def _jmesh():
    return jmake_mesh(data_parallel=2, model_parallel=2,
                      devices=jax.devices()[:4])


def _mesh():
    return make_mesh(2, 2, devices=["cpu"] * 4)


# ---- the sharded loss -------------------------------------------------------

@pytest.mark.parametrize("gather", [True, False])
def test_sharded_info_nce_loss_and_grads_match_jax(gather):
    rng = np.random.default_rng(0)
    t, i = (rng.normal(size=(8, 16)).astype(np.float32) for _ in range(2))
    jmesh = jmake_mesh(data_parallel=4, model_parallel=2)
    jl, (jgt, jgi) = jax.jit(jax.value_and_grad(
        lambda a, b: jcontrastive.sharded_info_nce_loss(
            jmesh, a, b, 0.05, gather_save_gradient=gather),
        argnums=(0, 1)))(jnp.asarray(t), jnp.asarray(i))
    mesh = make_mesh(4, 2, devices=["cpu"] * 8)
    tt, it = (torch.from_numpy(x).requires_grad_() for x in (t, i))
    loss = contrastive.sharded_info_nce_loss(
        mesh, list(tt.chunk(4)), list(it.chunk(4)), 0.05,
        gather_save_gradient=gather)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgt), **TOL)
    np.testing.assert_allclose(it.grad.numpy(), np.asarray(jgi), **TOL)
    # the same loss as the whole batch's; gradients only with the gather
    whole = contrastive.info_nce_loss(torch.from_numpy(t),
                                      torch.from_numpy(i), 0.05)
    np.testing.assert_allclose(float(loss.detach()), float(whole), **TOL)


# ---- the mesh trainer against the JAX mesh trainer --------------------------

@pytest.fixture(scope="module")
def tiny():
    jparams, jarch, jtok, jtmpl = j_build_model(
        JModelConfig(family=JFamily.TINY_DEBUG, dtype="float32", **TINY),
        captions=CAPTIONS)
    tok = WordPieceLiteTokenizer.from_corpus_captions(
        CAPTIONS, vocab_size=TINY["tiny_vocab_size"])
    spec = get_family_spec(ModelFamily.TINY_DEBUG,
                           ModelConfig(dtype="float32", **TINY))
    return (jparams, jarch, jtok, jtmpl), (spec.arch, tok, spec.template)


@pytest.fixture(scope="module")
def qwen():
    """Qwen2.5-VL's tiny fixed-grid family: image prompts with ``[3, B,
    T]`` M-RoPE ids."""
    jparams, jarch, jtok, jtmpl = j_build_model(
        JModelConfig(family=JFamily.TINY_QWEN_DEBUG, dtype="float32",
                     **QWEN_TINY), captions=CAPTIONS)
    spec = get_family_spec(ModelFamily.TINY_QWEN_DEBUG,
                           ModelConfig(dtype="float32", **QWEN_TINY))
    assert spec.arch == port_arch(jarch)
    tok = WordPieceLiteTokenizer.from_corpus_captions(
        CAPTIONS, vocab_size=QWEN_TINY["tiny_vocab_size"])
    return (noisy(jparams, 3), jarch, jtok, jtmpl), (spec.arch, tok,
                                                     spec.template)


@pytest.fixture(scope="module")
def anyres(tiny):
    """LLaVA-NeXT's anyres layout at tiny widths: the pixels a dict of
    tile stacks and feature maps, split per key over the shards."""
    from mllm_sparse_retrieval_tpu.models import mllm as jmllm

    (_, _, jtok, jtmpl), (_, tok, tmpl) = tiny
    jarch, arch = _anyres_pair()
    jparams = jmllm.init_params(jax.random.PRNGKey(5), jarch, jnp.float32)
    return (jparams, jarch, jtok, jtmpl), (arch, tok, tmpl)


CASES = {
    "zero1": dict(),
    "replicated_state": dict(shard_optimizer_state=False),
    "accum": dict(grad_accum_steps=2),
    "no_gather": dict(gather_save_gradient=False),
    "fsdp_full": dict(train_full=True, shard_params_data_axis=True,
                      learning_rate=1e-4),
    "qwen_mrope": dict(),
}


# JAX runs by case; ZeRO-1 on and off place the same arithmetic, so the
# replicated-state case is held to the ZeRO-1 case's JAX run
_JAX_RUNS = {}


def _jax_run(case, jparams, jarch, jtok, jtmpl, jad, kw, full):
    key = "zero1" if case == "replicated_state" else case
    if key not in _JAX_RUNS:
        jkw = dict(kw, shard_optimizer_state=True) if key == "zero1" else kw
        jt = jtrainer.ContrastiveTrainer(jparams, jarch,
                                         None if full else jad,
                                         JTrainConfig(**jkw), mesh=_jmesh())
        jcol = jtrainer.make_collator(jtok, jtmpl, jarch)
        jex = _examples(True)
        batches = [jcol([jex[r] for r in rows], TEXT_LEN) for rows in STEPS]
        losses = [jt.train_on_batch(jb) for jb in batches]
        assert jt.step == len(STEPS)
        _JAX_RUNS[key] = (batches, losses, _np_tree(
            jt.params if full else jt.adapters), jt)
    return _JAX_RUNS[key]


def _leaves_close(got, ref):
    gl, rl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)
    assert len(gl) == len(rl)
    for g, r in zip(gl, rl):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   **STEP_TOL)


def _assert_steps_on_own_gradients(pt, steps, batches, jparams, jarch, jad,
                                   jt, tau):
    """Each step's ``(adapters, gradients)`` as the port's update got them
    (the gradients in ``_trainable_leaves`` order): the gradients against
    the JAX package's gradient of the same loss at those adapters (TOL),
    then the port's leaves against the JAX trainer's optimizer chain run on
    those gradients (STEP_TOL)."""
    def loss_fn(adapters, b):
        _, t = j_encode_any(jparams, jarch, b.text_ids, b.text_mask, None,
                            lora=adapters)
        _, i = j_encode_any(jparams, jarch, b.image_ids, b.image_mask,
                            b.pixels, lora=adapters,
                            position_ids=b.image_pos_ids)
        return jcontrastive.info_nce_loss(t, i, tau)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    slot = {id(x): k for k, x in enumerate(pt._trainable_leaves())}
    cur, state = jad, jt.tx.init(jad)
    for b, (before, g) in zip(batches, steps):
        _, jg = value_and_grad(before, b)
        tree = jax.tree_util.tree_map(
            lambda x: jnp.asarray(g[slot[id(x)]].numpy()), pt.adapters)
        for got, ref in zip(jax.tree_util.tree_leaves(tree),
                            jax.tree_util.tree_leaves(jg)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                       **TOL)
        updates, state = jt.tx.update(tree, state, cur)
        cur = optax.apply_updates(cur, updates)
    _leaves_close(pt.adapters, cur)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_trainer_matches_jax_mesh_trainer(tiny, qwen, case):
    (jparams, jarch, jtok, jtmpl), (arch, tok, tmpl) = \
        qwen if case == "qwen_mrope" else tiny
    kw = dict(learning_rate=3e-3, tau=0.1, lora_rank=4, lora_alpha=8,
              lora_dropout=0.0) | CASES[case]
    full = kw.get("train_full", False)
    jad, ad = _adapters(jparams, jarch, projector=case != "qwen_mrope")
    mesh = _mesh()
    batches, jlosses, jfinal, jt = _jax_run(case, jparams, jarch, jtok,
                                            jtmpl, jad, kw, full)
    pt = ContrastiveTrainer(from_jax_params(_np_tree(jparams), "cpu"), arch,
                            None if full else from_jax_lora(ad, "cpu"),
                            TrainConfig(**kw), mesh=mesh, device="cpu")
    if full:
        n = assert_fsdp_sharded(pt.params, mesh)
        assert n == j_assert_fsdp(jt.params, jt.mesh) > 0
        assert all(isinstance(m, Sharded) == isinstance(x, Sharded)
                   for m, x in zip(pt.opt_state["mu"], pt._leaves()))
    elif kw.get("shard_optimizer_state", True):
        assert any(isinstance(m, Sharded) for m in pt.opt_state["mu"])
    else:
        assert not any(isinstance(m, Sharded) for m in pt.opt_state["mu"])
    steps = []

    def update(leaves, g):
        steps.append((jax.tree_util.tree_map(
            lambda x: x.detach().numpy().copy(), pt.adapters),
            [x.detach().clone() for x in g]))
        ContrastiveTrainer._update(pt, leaves, g)

    if case == "qwen_mrope":
        pt._update = update
    for jb, jl in zip(batches, jlosses):
        pb = _port_batch(jb)
        pb.image_pos_ids = None if jb.image_pos_ids is None else \
            np.asarray(jb.image_pos_ids)
        if case == "qwen_mrope":
            assert pb.image_pos_ids.shape == (3,) + pb.image_ids.shape
        np.testing.assert_allclose(pt.train_on_batch(pb), jl, **TOL)
    assert pt.step == len(STEPS)
    if full:
        _leaves_close(pt.merged_params(), jfinal)
        assert assert_fsdp_sharded(pt.params, mesh) == n
    else:
        if case == "qwen_mrope":
            _assert_steps_on_own_gradients(pt, steps, batches, jparams,
                                           jarch, jad, jt, kw["tau"])
        else:
            _leaves_close(pt.adapters, jfinal)
        moved = [float(np.abs(g.detach().numpy() - a).max()) for g, a in
                 zip(jax.tree_util.tree_leaves(pt.adapters),
                     jax.tree_util.tree_leaves(_np_tree(jad)))]
        assert max(moved) > 1e-3


# ---- the port against itself: dropout, checkpoints --------------------------

def _port_trainer(tiny, mesh, **over):
    (jparams, jarch, jtok, jtmpl), (arch, tok, tmpl) = tiny
    cfg = TrainConfig(**(dict(learning_rate=3e-3, tau=0.1, lora_rank=4,
                              lora_alpha=8, lora_dropout=0.1, seed=3)
                         | over))
    ad = from_jax_lora(_adapters(jparams, jarch, seed=1)[1], "cpu")
    for blk in ad["text"]["blocks"]:      # adapters that do something
        for entry in blk.values():
            entry["b"].add_(0.05)
    return ContrastiveTrainer(from_jax_params(_np_tree(jparams), "cpu"),
                              arch, ad, cfg, mesh=mesh, device="cpu")


def _port_batches(tiny):
    _, (arch, tok, tmpl) = tiny
    col = make_collator(tok, tmpl, arch)
    ex = _examples(False)
    return [col([ex[r] for r in rows]) for rows in STEPS]


def _state(t):
    """Every trainable and optimizer tensor of ``t``, whole, on the CPU."""
    def whole(x):
        return (x.gather("cpu") if isinstance(x, Sharded) else x).detach()
    return ([whole(x) for x in t._leaves()]
            + [whole(x) for k in ("mu", "nu") for x in t.opt_state[k]])


@pytest.mark.parametrize("family", ["fixed", "anyres"])
def test_mesh_step_with_dropout_equals_the_unsharded_step(tiny, anyres,
                                                          family):
    """Each data shard draws its rows of the whole batch's LoRA dropout
    masks, so the 2 x 2 mesh trains as the unsharded trainer does; anyres
    pixels (a dict of tile stacks and feature maps) split per key."""
    model = anyres if family == "anyres" else tiny
    batches = _port_batches(model)
    if family == "anyres":
        assert set(batches[0].pixels) == {"pixels", "feature_index"}
    runs = {}
    for name, mesh, drop, steps in (("one", None, 0.1, 3),
                                    ("mesh", _mesh(), 0.1, 3),
                                    ("mesh_nodrop", _mesh(), 0.0, 1)):
        t = _port_trainer(model, mesh, lora_dropout=drop)
        runs[name] = ([t.train_on_batch(b) for b in batches[:steps]],
                      _state(t))
    (one, s_one), (mesh, s_mesh) = runs["one"], runs["mesh"]
    np.testing.assert_allclose(mesh, one, **TOL)
    for a, b in zip(s_mesh, s_one):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **STEP_TOL)
    # the masks matter: without them the run differs
    assert abs(runs["mesh_nodrop"][0][0] - one[0]) > 1e-4


def test_checkpoints_move_between_mesh_and_unsharded_trainers(tiny,
                                                              tmp_path):
    """A ZeRO-1 mesh checkpoint restores into a trainer without a mesh and
    back, every tensor bit-equal, and the mesh run resumed that way replays
    the straight mesh run exactly."""
    batches = _port_batches(tiny)
    straight = _port_trainer(tiny, _mesh())
    want = [straight.train_on_batch(b) for b in batches]
    a = _port_trainer(tiny, _mesh())
    got = [a.train_on_batch(batches[0])]
    a.save_checkpoint(str(tmp_path / "a"))
    b = _port_trainer(tiny, None)
    assert b.restore_checkpoint(str(tmp_path / "a")) == 1
    for x, y in zip(_state(b), _state(a)):
        assert torch.equal(x, y)
    b.save_checkpoint(str(tmp_path / "b"))
    c = _port_trainer(tiny, _mesh())
    assert any(isinstance(m, Sharded) for m in c.opt_state["mu"])
    assert c.restore_checkpoint(str(tmp_path / "b")) == 1
    for x, y in zip(_state(c), _state(a)):
        assert torch.equal(x, y)
    got += [c.train_on_batch(bt) for bt in batches[1:]]
    assert got == want
    for x, y in zip(_state(c), _state(straight)):
        assert torch.equal(x, y)


def test_fsdp_checkpoint_holds_whole_tensors(tiny, tmp_path):
    (jparams, _, _, _), (arch, _, _) = tiny
    cfg = TrainConfig(learning_rate=1e-4, tau=0.1, train_full=True,
                      shard_params_data_axis=True)
    t = ContrastiveTrainer(from_jax_params(_np_tree(jparams), "cpu"), arch,
                           None, cfg, mesh=_mesh(), device="cpu")
    t.train_on_batch(_port_batches(tiny)[0])
    t.save_checkpoint(str(tmp_path))
    saved = torch.load(tmp_path / "step_1" / "checkpoint.pt",
                       weights_only=True)
    flat = jax.tree_util.tree_leaves(saved["adapters"])
    assert [tuple(x.shape) for x in flat] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jparams)]
    one = ContrastiveTrainer(from_jax_params(_np_tree(jparams), "cpu"),
                             arch, None, cfg, device="cpu")
    assert one.restore_checkpoint(str(tmp_path)) == 1
    for x, y in zip(_state(one), _state(t)):
        assert torch.equal(x, y)


def test_mesh_trainer_refuses_indivisible_batches(tiny):
    t = _port_trainer(tiny, make_mesh(4, 1, devices=["cpu"] * 4),
                      grad_accum_steps=2)
    with pytest.raises(ValueError, match="does not split over 4 data"):
        t.train_on_batch(_port_batches(tiny)[0])


# ---- the CLI ----------------------------------------------------------------

def test_train_cli_mesh_matches_the_jax_cli(tmp_path, capsys, monkeypatch):
    """``cli.train --mesh --device cpu`` (a 1x1 mesh of the CPU) against
    the JAX CLI's ``--mesh`` (an 8 x 1 mesh of the virtual devices), the
    JAX weights and adapter draw carried across as in
    ``test_torch_cli_train.py``."""
    from mllm_sparse_retrieval_tpu.cli import train as jcli_train
    from mllm_sparse_retrieval_tpu_torch.cli import train as cli_train
    from tests.test_torch_cli_train import _args, _close, _karpathy, _np
    from mllm_sparse_retrieval_tpu_torch.cli import prepare_data as cli_prep

    root = tmp_path / "data"
    js = _karpathy(tmp_path / "dataset.json")
    cli_prep.main(["split", "--json", str(js), "--out-dir",
                   str(root / "port" / "flickr"), "--dataset", "flickr"])
    cli_prep.main(["few-shot", "--train-csv",
                   str(root / "port" / "flickr" / "flickr_train.csv"),
                   "--out-csv",
                   str(root / "port" / "flickr" / "flickr_train_8.csv"),
                   "--num-images", "8"])
    built = {}
    real_j = jcli_train.build_model

    def j_build(cfg, captions=None, seed=0):
        built["jax"] = real_j(cfg, captions, seed)
        return built["jax"]

    monkeypatch.setattr(jcli_train, "build_model", j_build)
    extra = ("--mesh", "--batch-size", "8", "--num-epochs", "2")
    jcli_train.main(_args(root, "tiny_debug", tmp_path / "jax", *extra))
    jparams, jarch = built["jax"][0], built["jax"][1]
    real = cli_train.build_model

    def build(cfg, captions=None, seed=0, device="cuda"):
        _, arch, tok, tmpl = real(cfg, captions, seed, device)
        return from_jax_params(_np(jparams), device), arch, tok, tmpl

    def init_lora(gen, params, arch, rank, alpha, train_vision,
                  train_projector, device):
        return from_jax_lora(_np(jlora.init_lora(
            jax.random.PRNGKey(0), jparams, jarch, rank=rank, alpha=alpha,
            train_vision=train_vision, train_projector=train_projector)),
            device)

    seen = {}

    class Recording(ContrastiveTrainer):
        def __init__(self, *a, **kw):
            seen["mesh"] = kw.get("mesh")
            super().__init__(*a, **kw)

    monkeypatch.setattr(cli_train, "build_model", build)
    monkeypatch.setattr(cli_train.lora_lib, "init_lora", init_lora)
    monkeypatch.setattr(cli_train, "ContrastiveTrainer", Recording)
    cli_train.main(_args(root, "tiny_debug", tmp_path / "port", "--device",
                         "cpu", *extra))
    assert dict(seen["mesh"].shape) == {"data": 1, "model": 1}
    printed = capsys.readouterr().out.split()
    assert printed[-1] == str(tmp_path / "port" / "lora.pkl")
    with open(tmp_path / "port" / "lora.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jax" / "lora.pkl", "rb") as f:
        want = _np(pickle.load(f))
    _close(got, want)

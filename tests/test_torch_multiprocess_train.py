"""PyTorch port, training across processes: two ``gloo`` processes on the
CPU (``tests/torch_multiprocess_worker.py``, JAX blocked there), each a 1x1
local mesh, the data axis global over the two, against the JAX mesh trainer
over a data axis of 2 (the conftest's virtual CPU devices, ``_jax_run`` of
``test_torch_mesh_train.py``) for ZeRO-1, replicated optimizer state,
``gather_save_gradient=False``, gradient accumulation and an FSDP full
finetune; then the port against itself: a run at ``lora_dropout=0.1``
against the one-process 2 x 1 mesh, the first gradient with clipping off
against the one-process mesh's, its checkpoint restored in one process,
and ``cli.train --mesh`` under the two-process launch against the
one-process ``--mesh`` over the same global data axis.

Both processes start once for the module, with every case in that launch,
and write their results to files; the JAX runs go on while they train.

Tolerances are ``test_torch_mesh_train.py``'s (f32 on the CPU):
``atol=rtol=1e-5`` on every loss, ``atol=rtol=1e-4`` (STEP_TOL) on the
trained leaves after several Adam steps. The two processes hold bit-equal
trees (their gradients are one all-reduce's result), a checkpoint restores
bit-equal, and the collectives' small sums are exact.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu.train import trainer as jtrainer
from mllm_sparse_retrieval_tpu_torch.cli import train as cli_train
from mllm_sparse_retrieval_tpu_torch.configs import TrainConfig
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import (
    from_jax_lora, from_jax_params)
from mllm_sparse_retrieval_tpu_torch.parallel import make_mesh
from mllm_sparse_retrieval_tpu_torch.train.trainer import ContrastiveTrainer
from tests.test_torch_cli_train import _args, data_root  # noqa: F401
from tests.test_torch_mesh_train import (  # noqa: F401
    CASES, STEPS, TEXT_LEN, _jax_run, _leaves_close, tiny)
from tests.test_torch_train import (
    STEP_TOL, TOL, _adapters, _examples, _np_tree, _port_batch)
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_multiprocess_worker.py"
JAX_CASES = ("zero1", "replicated_state", "no_gather", "accum", "fsdp_full")
BASE = dict(learning_rate=3e-3, tau=0.1, lora_rank=4, lora_alpha=8,
            lora_dropout=0.0)
DROPOUT = dict(BASE, lora_dropout=0.1, seed=3)
UNCLIPPED = dict(BASE, max_grad_norm=0.0)
CLI_EXTRA = ("--device", "cpu", "--mesh", "--lora-dropout", "0.1",
             "--checkpoint-every", "2")


def _dropout_adapters(jparams, jarch):
    """``test_torch_mesh_train._port_trainer``'s adapters: seed 1, the
    text blocks' ``b`` moved off zero so dropout changes the result."""
    ad = _adapters(jparams, jarch, seed=1)[1]
    for blk in ad["text"]["blocks"]:
        for entry in blk.values():
            entry["b"] = entry["b"] + np.float32(0.05)
    return ad


@pytest.fixture(scope="module")
def launch(tiny, data_root, tmp_path_factory):  # noqa: F811
    """Start the two processes with every case; returns a function that
    waits for them and gives ``(rank 0's results, rank 1's, out dir,
    the inputs they were given)``."""
    (jparams, jarch, jtok, jtmpl), (arch, _, _) = tiny
    out = tmp_path_factory.mktemp("two_processes")
    jcol = jtrainer.make_collator(jtok, jtmpl, jarch)
    jex = _examples(True)
    batches = [_port_batch(jcol([jex[r] for r in rows], TEXT_LEN))
               for rows in STEPS]
    cases = [dict(name=c, kw=BASE | CASES[c], adapters="base",
                  steps=len(STEPS)) for c in JAX_CASES]
    cases.append(dict(name="dropout", kw=DROPOUT, adapters="dropout",
                      steps=len(STEPS), checkpoint_at=len(STEPS)))
    cases += [dict(name=f"unclipped_{g}", adapters="base", steps=1,
                   kw=dict(UNCLIPPED, gather_save_gradient=g))
              for g in (True, False)]
    inputs = dict(arch=arch, params=_np_tree(jparams), batches=batches,
                  adapters={"base": _adapters(jparams, jarch)[1],
                            "dropout": _dropout_adapters(jparams, jarch)},
                  cases=cases,
                  cli=_args(data_root, "tiny_debug", out / "cli", *CLI_EXTRA))
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(out / "inputs.pkl"), str(out)],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    done = {}

    def wait():
        if not done:
            try:
                for p in procs:
                    _, err = p.communicate(timeout=300)
                    assert p.returncode == 0, err[-4000:]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for rank in range(2):
                with open(out / f"rank{rank}.pkl", "rb") as f:
                    done[rank] = pickle.load(f)
        return done[0], done[1], out, inputs

    yield wait
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _same(a, b):
    """Two trees of numpy arrays, bit-equal."""
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def test_collectives_over_two_gloo_processes(launch):
    """The gathered rows' backward sums every rank's gradient onto the
    rank's own rows; the gather of several pieces (two dtypes) and the
    global sum; and the model axis
    stays inside a process. The workers never imported JAX."""
    r0, r1, _, inputs = launch()
    for rank, r in enumerate((r0, r1)):
        c = r["collectives"]
        assert c["rows"] == [[0.0, 1.0, 2.0], [1.0, 2.0, 3.0]]
        assert c["grad"] == [3.0 * (rank + 1)] * 3
        assert c["each"] == [[0.0, 0.0, 1.0, 1.0], [[0, 0], [1, 1]]]
        assert (c["total"], c["share_grad"]) == (3.0, 1.0)
        assert "stays inside a process" in c["refused"]
        assert r["jax_imported"] == []


@pytest.mark.parametrize("case", JAX_CASES)
def test_two_processes_train_as_the_jax_mesh_trainer(tiny, launch, case):
    (jparams, jarch, jtok, jtmpl), _ = tiny
    r0, r1, _, _ = launch()
    kw = BASE | CASES[case]
    full = kw.get("train_full", False)
    jad, _ = _adapters(jparams, jarch)
    _, jlosses, jfinal, _ = _jax_run(case, jparams, jarch, jtok, jtmpl, jad,
                                     kw, full)
    got = r0[case]
    assert got["step"] == len(STEPS)
    np.testing.assert_allclose(got["losses"], jlosses, **TOL)
    _leaves_close(jax.tree_util.tree_map(torch.from_numpy, got["final"]),
                  jfinal)
    # ZeRO-1 splits moments over the global data axis; replicated state
    # and FSDP (moments split like their params) do not split whole leaves
    if case == "replicated_state":
        assert got["split_moments"] == 0
    else:
        assert got["split_moments"] > 0
    # both processes end with the same trees
    assert r1[case]["losses"] == got["losses"]
    _same(r1[case]["final"], got["final"])
    _same(r1[case]["state"], got["state"])


@pytest.mark.parametrize("gather", [True, False])
def test_two_process_gradient_equals_the_one_process_mesh_gradient(
        tiny, launch, gather):
    """The gradient itself, with clipping off: Adam's update is blind to
    the gradient's scale, and so is clipping by the global norm, so the
    losses and trees above would not show a gradient off by the process
    count. The first step's first moment (0.1 x the gradient) equals the
    one-process 2 x 1 mesh's to 1e-4 of its largest element."""
    from tests.test_torch_mesh_train import _state

    r0, _, _, inputs = launch()
    _, (arch, _, _) = tiny
    ref = ContrastiveTrainer(
        from_jax_params(inputs["params"], "cpu"), arch,
        from_jax_lora(inputs["adapters"]["base"], "cpu"),
        TrainConfig(**UNCLIPPED, gather_save_gradient=gather),
        mesh=make_mesh(2, 1, devices=["cpu"] * 2), device="cpu")
    ref.train_on_batch(inputs["batches"][0])
    want = _state(ref)[len(ref._leaves()):][:len(ref.opt_state["mu"])]
    got = r0[f"unclipped_{gather}"]["first_moment"]
    scale = max(float(w.abs().max()) for w in want)
    assert scale > 0 and len(want) == len(got)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, w.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale)


def _one_process_trainer(tiny, mesh):
    (jparams, jarch, _, _), (arch, _, _) = tiny
    return ContrastiveTrainer(
        from_jax_params(_np_tree(jparams), "cpu"), arch,
        from_jax_lora(_dropout_adapters(jparams, jarch), "cpu"),
        TrainConfig(**DROPOUT), mesh=mesh, device="cpu")


def test_two_process_steps_with_dropout_equal_the_one_process_mesh(tiny,
                                                                   launch):
    """Each process draws its rows of the global batch's dropout masks, so
    two processes train as the one-process 2 x 1 mesh does."""
    from tests.test_torch_mesh_train import _state

    r0, _, _, _ = launch()
    (jparams, jarch, jtok, jtmpl), _ = tiny
    jcol = jtrainer.make_collator(jtok, jtmpl, jarch)
    jex = _examples(True)
    t = _one_process_trainer(tiny, make_mesh(2, 1, devices=["cpu"] * 2))
    losses = [t.train_on_batch(_port_batch(jcol([jex[r] for r in rows],
                                                TEXT_LEN)))
              for rows in STEPS]
    np.testing.assert_allclose(r0["dropout"]["losses"], losses, **TOL)
    for a, b in zip(r0["dropout"]["state"], _state(t)):
        np.testing.assert_allclose(a, b.numpy(), **STEP_TOL)


def test_fsdp_over_processes_refuses_several_devices_a_process(tiny):
    """A departure the port keeps: FSDP over processes gathers each piece
    in autograd's order, one order in every process only with one device
    a process. The check runs in ``__init__`` before any device work, so a
    two-process mesh of two distinct devices here reaches it; the JAX
    trainer shards FSDP over whatever mesh it gets."""
    from mllm_sparse_retrieval_tpu_torch.parallel import Mesh

    (jparams, _, _, _), (arch, _, _) = tiny
    mesh = Mesh(np.array([[torch.device("cpu")], [torch.device("meta")]],
                         dtype=object), processes=2)
    with pytest.raises(ValueError, match="one device per process; this "
                                         "process has 2"):
        ContrastiveTrainer(from_jax_params(_np_tree(jparams), "cpu"), arch,
                           None, TrainConfig(**(BASE | CASES["fsdp_full"])),
                           mesh=mesh, device="cpu")


def test_two_process_checkpoint_restores_bit_equal_in_one_process(tiny,
                                                                  launch):
    """The primary process wrote whole tensors (ZeRO-1 moments gathered
    over the processes); a trainer without a mesh restores them bit-equal,
    and so does a one-process mesh trainer that splits them again."""
    from tests.test_torch_mesh_train import _state

    r0, _, out, _ = launch()
    ckpt = out / "dropout"
    assert (ckpt / "latest").read_text() == str(len(STEPS))
    for mesh in (None, make_mesh(2, 1, devices=["cpu"] * 2)):
        t = _one_process_trainer(tiny, mesh)
        assert t.restore_checkpoint(str(ckpt)) == len(STEPS)
        for a, b in zip(r0["dropout"]["state"], _state(t)):
            np.testing.assert_array_equal(a, b.numpy())


def test_train_cli_mesh_over_two_processes_matches_one_process(
        launch, data_root, tmp_path, capsys, monkeypatch):  # noqa: F811
    """``cli.train --mesh`` under the two-process launch (only rank 0 wrote
    ``lora.pkl`` and ``ckpts/``) against the one-process ``--mesh`` over a
    2 x 1 mesh of the CPU: the same global data axis."""
    _, _, out, _ = launch()
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(cli_train, "mesh_from_args",
                        lambda args: make_mesh(2, 1, devices=["cpu"] * 2))
    cli_train.main(_args(data_root, "tiny_debug", tmp_path, *CLI_EXTRA))
    assert capsys.readouterr().out.split()[-1] == str(tmp_path / "lora.pkl")
    with open(tmp_path / "lora.pkl", "rb") as f:
        want = pickle.load(f)
    with open(out / "cli" / "lora.pkl", "rb") as f:
        got = pickle.load(f)
    la, lb = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want) and len(la) > 0
    for a, b in zip(la, lb):
        np.testing.assert_allclose(a, b, **STEP_TOL)
    assert sorted(os.listdir(out / "cli" / "ckpts")) == sorted(
        os.listdir(tmp_path / "ckpts"))


@pytest.mark.parametrize("missing", ["MASTER_ADDR", "MASTER_PORT", "RANK"])
def test_train_cli_mesh_refuses_a_launch_without_its_variables(
        data_root, tmp_path, monkeypatch, missing):  # noqa: F811
    """Under ``WORLD_SIZE`` > 1 a missing launcher variable raises, naming
    it, before anything trains or is written."""
    for name, value in (("WORLD_SIZE", "2"), ("MASTER_ADDR", "localhost"),
                        ("MASTER_PORT", "29500"), ("RANK", "0")):
        monkeypatch.setenv(name, value)
    monkeypatch.delenv(missing)
    args = cli_train.build_parser().parse_args(
        _args(data_root, "tiny_debug", tmp_path, *CLI_EXTRA))
    with pytest.raises(ValueError, match=missing):
        cli_train.run(args)
    assert not torch.distributed.is_initialized()
    assert not (tmp_path / "lora.pkl").exists()

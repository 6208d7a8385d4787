"""One process of a two-process training launch, for
``tests/test_torch_multiprocess_train.py``.

    python tests/torch_multiprocess_worker.py INPUTS.pkl OUT_DIR

with the launcher's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
``RANK`` in the environment. It blocks JAX and the JAX package before it
imports anything, joins the ``gloo`` group, and runs every case of
``INPUTS`` (a pickle the test writes: the tiny port arch, the numpy
weights and adapters, the collated global batches, the cases' trainer
configs) on a 1x1 local mesh of the CPU, the data axis global over the
processes. Each case's losses, final trainable tree (``merged_params`` for
a full finetune), whole optimizer state and Adam's first moment after the
first step go to ``OUT_DIR/rank<r>.pkl``;
a case may also write a checkpoint under ``OUT_DIR/<case>``. Then, when
``INPUTS`` names CLI arguments, ``cli.train.main`` runs with them in the
same group.
"""

import sys

for _name in ("jax", "jaxlib", "mllm_sparse_retrieval_tpu"):
    sys.modules[_name] = None           # any import of these now fails

import os  # noqa: E402
import pickle  # noqa: E402

import torch  # noqa: E402

from mllm_sparse_retrieval_tpu_torch.configs import TrainConfig  # noqa: E402
from mllm_sparse_retrieval_tpu_torch.models import lora  # noqa: E402
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import (  # noqa: E402
    from_jax_lora, from_jax_params)
from mllm_sparse_retrieval_tpu_torch.parallel import (  # noqa: E402
    Sharded, make_mesh)
from mllm_sparse_retrieval_tpu_torch.parallel.multihost import (  # noqa: E402
    all_gather_each, all_gather_rows, global_sum, initialize_multihost,
    process_view)
from mllm_sparse_retrieval_tpu_torch.train.trainer import (  # noqa: E402
    ContrastiveTrainer)


def whole_state(t):
    """Every trainable and optimizer tensor of ``t``, whole, as numpy (a
    split one gathered over the processes)."""
    def whole(x):
        return (x.gather("cpu") if isinstance(x, Sharded) else x).detach() \
            .numpy().copy()
    return ([whole(x) for x in t._leaves()]
            + [whole(x) for k in ("mu", "nu") for x in t.opt_state[k]])


def collectives():
    """The trainer's collectives on small tensors: rank ``r`` gathers rows
    ``arange(3) + r`` and weighs the gathered row ``q`` by ``(q + 1) * (r +
    1)``, so its rows' gradient is the sum over the ranks ``3 * (r + 1)``;
    ``all_gather_each`` and ``global_sum``; and the mesh's refusal to put
    a model axis across processes."""
    rank = process_view().rank
    y = (torch.arange(3.0) + rank).requires_grad_()
    rows = all_gather_rows(y[None], 0)
    (rows * torch.tensor([[1.0], [2.0]]) * (rank + 1)).sum().backward()
    share = torch.tensor(float(rank + 1), requires_grad=True)
    total = global_sum(share)
    total.backward()
    try:
        make_mesh(model_parallel=2, devices=["cpu"])
        refused = None
    except ValueError as e:
        refused = str(e)
    return dict(rows=rows.detach().tolist(), grad=y.grad.tolist(),
                each=[t.tolist() for t in all_gather_each(
                    [torch.full((2,), float(rank)),
                     torch.full((1, 2), rank, dtype=torch.int64)])],
                total=float(total), share_grad=float(share.grad),
                refused=refused)


def run_case(inputs, case, out_dir):
    full = case["kw"].get("train_full", False)
    mesh = make_mesh(devices=["cpu"])
    assert (mesh.processes, mesh.data_size) == (2, 2), mesh
    adapters = None if full else from_jax_lora(
        inputs["adapters"][case["adapters"]], "cpu")
    t = ContrastiveTrainer(from_jax_params(inputs["params"], "cpu"),
                           inputs["arch"], adapters,
                           TrainConfig(**case["kw"]), mesh=mesh,
                           device="cpu")
    split = sum(isinstance(m, Sharded) for m in t.opt_state["mu"])
    losses, first_moment = [], None
    for i, b in enumerate(inputs["batches"][:case["steps"]]):
        losses.append(t.train_on_batch(b))
        if i == 0:      # Adam's first moment: 0.1 x the first gradient
            first_moment = whole_state(t)[len(t._leaves()):][
                :len(t.opt_state["mu"])]
        if case.get("checkpoint_at") == i + 1:
            t.save_checkpoint(os.path.join(out_dir, case["name"]))
    final = lora.to_numpy(t.merged_params() if full else t.adapters)
    return dict(losses=losses, final=final, state=whole_state(t),
                first_moment=first_moment, split_moments=split,
                step=t.step)


def main():
    inputs_path, out_dir = sys.argv[1], sys.argv[2]
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    torch.manual_seed(0)
    assert initialize_multihost(device="cpu")
    view = process_view()
    assert view.backend == "gloo" and view.world_size == 2
    results = {"collectives": collectives()}
    results.update({case["name"]: run_case(inputs, case, out_dir)
                    for case in inputs["cases"]})
    if inputs.get("cli"):
        from mllm_sparse_retrieval_tpu_torch.cli import train as cli_train

        cli_train.main(inputs["cli"])
    results["jax_imported"] = [m for m in sys.modules
                               if m.split(".")[0] in ("jax", "jaxlib")
                               and sys.modules[m] is not None]
    with open(os.path.join(out_dir, f"rank{view.rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

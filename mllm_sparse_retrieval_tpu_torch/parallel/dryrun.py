"""A dry run of every parallel form at tiny shapes (the JAX package's
``__graft_entry__.dryrun_multichip``).

    python -c "from mllm_sparse_retrieval_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(8)"           # the cards
    ... dryrun_multichip(8, device="cpu")                # the CPU

Eight legs over an ``n_devices`` mesh, each with the JAX dry run's shapes
and checks: (1) a LoRA training step with tensor-parallel base weights and
ZeRO-1 optimizer state; (2) an FSDP full-finetune step; (3) sharded TAAT,
MIPS, SQ8 and ANN searches against their unsharded forms; (4) the mesh's
fused hybrid search against the unsharded one; (5) a dp x pp pipelined
contrastive step; (6) at ``n_devices % 8 == 0`` the dp x pp x tp pipeline
against the sequential decoder; (7) the ring-attention decoder against
the sequential one; (8) the expert-parallel MoE forward and gradients
against the unsharded layer. With fewer devices than ``n_devices`` one
device repeats (``cuda:0`` on the cards, ``cpu`` here): the sharded code
paths run, copies between distinct devices do not. No subprocess is
needed, since no backend is latched.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def dryrun_devices(n_devices: int, device="cuda") -> List[torch.device]:
    """``n_devices`` devices of ``device``'s type: distinct CUDA cards when
    there are enough, else one device repeated."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        return [torch.device("cuda", i) for i in range(n_devices)]
    if dev.type == "cuda":
        return [torch.device("cuda", 0)] * n_devices
    return [dev] * n_devices


def _flagship(dev):
    """The JAX dry run's tiny model: vocab 512, hidden 64, 2 layers of 4
    heads, a 32 px ViT of 16 px patches, f32."""
    from mllm_sparse_retrieval_tpu_torch.models import mllm
    from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
    from mllm_sparse_retrieval_tpu_torch.models.mllm import MLLMConfig
    from mllm_sparse_retrieval_tpu_torch.models.vit import ViTConfig

    arch = MLLMConfig(
        vision=ViTConfig(image_size=32, patch_size=16, hidden_size=256,
                         num_layers=2, num_heads=8, feature_layer=-2),
        text=LlamaConfig(vocab_size=512, hidden_size=64, num_layers=2,
                         num_heads=4, num_kv_heads=1, intermediate_size=256,
                         rope_theta=500000.0),
        image_token_id=4)
    gen = torch.Generator(device=dev).manual_seed(0)
    return mllm.init_params(arch, gen, dev, torch.float32), arch


def dryrun_multichip(n_devices: int, device="cuda") -> str:
    """Run the eight legs; raises on a failed check, returns the summary
    line it prints."""
    from mllm_sparse_retrieval_tpu_torch.configs import TrainConfig
    from mllm_sparse_retrieval_tpu_torch.index.ann import DenseANNIndex
    from mllm_sparse_retrieval_tpu_torch.index.dense import DenseFlatIndex
    from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex
    from mllm_sparse_retrieval_tpu_torch.models import llama, lora
    from mllm_sparse_retrieval_tpu_torch.parallel import ep, pp, sp
    from mllm_sparse_retrieval_tpu_torch.parallel.fsdp import (
        assert_fsdp_sharded)
    from mllm_sparse_retrieval_tpu_torch.parallel.mesh import (
        DATA_AXIS, MODEL_AXIS, make_mesh)
    from mllm_sparse_retrieval_tpu_torch.parallel.tp import shard_params_tp
    from mllm_sparse_retrieval_tpu_torch.search.device_fusion import (
        FusedHybridSearcher)
    from mllm_sparse_retrieval_tpu_torch.train.contrastive import (
        info_nce_loss)
    from mllm_sparse_retrieval_tpu_torch.train.trainer import (
        ContrastiveTrainer, TrainBatch)

    devices = dryrun_devices(n_devices, device)
    lead = devices[0]
    model_parallel = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices // model_parallel, model_parallel,
                     devices=devices)
    data_parallel = mesh.shape[DATA_AXIS]
    rng = np.random.default_rng(0)

    # 1. LoRA step: tensor-parallel base weights, ZeRO-1 optimizer state
    params, arch = _flagship(lead)
    params_tp = shard_params_tp(params, mesh)
    gen = torch.Generator(device=lead).manual_seed(1)
    adapters = lora.init_lora(gen, params, arch, rank=4, alpha=8,
                              device=lead)
    batch, seq, n_img = 2 * data_parallel, 48, arch.num_image_tokens
    t_ids = rng.integers(5, arch.text.vocab_size,
                         size=(batch, seq)).astype(np.int32)
    t_mask = np.ones((batch, seq), np.int32)
    i_ids = t_ids.copy()
    i_ids[:, 1:1 + n_img] = arch.image_token_id
    i_mask = np.ones((batch, seq), np.int32)
    pixels = rng.normal(size=(batch, arch.vision.image_size,
                              arch.vision.image_size, 3)).astype(np.float32)
    tb = TrainBatch(t_ids, t_mask, i_ids, i_mask, pixels)
    cfg = TrainConfig(learning_rate=1e-3, tau=0.05, lora_dropout=0.0,
                      max_grad_norm=0.0)
    trainer = ContrastiveTrainer(params_tp, arch, adapters, cfg, mesh=mesh)
    loss = trainer.train_on_batch(tb)
    assert np.isfinite(loss), f"non-finite training loss: {loss}"
    zero1 = sum(1 for m in trainer.opt_state["mu"]
                if hasattr(m, "pieces"))

    # 2. FSDP full finetune: parameters and moments split over data
    host, _ = _flagship(lead)
    fcfg = TrainConfig(learning_rate=1e-4, tau=0.05, train_full=True,
                       shard_params_data_axis=True,
                       shard_optimizer_state=True)
    ftrainer = ContrastiveTrainer(host, arch, None, fcfg, mesh=mesh)
    n_sharded = assert_fsdp_sharded(ftrainer.params, mesh)
    fsdp_loss = ftrainer.train_on_batch(tb)
    assert np.isfinite(fsdp_loss), f"non-finite FSDP loss: {fsdp_loss}"
    del ftrainer, host

    # 3. sharded TAAT, MIPS, SQ8 and ANN against the unsharded forms
    n_docs, n_terms = 4 * data_parallel + 3, 60      # not divisible
    doc_t = rng.integers(0, n_terms, size=(n_docs, 6)).astype(np.int32)
    doc_w = rng.integers(1, 90, size=(n_docs, 6)).astype(np.float32)
    impact = ImpactIndex.from_packed_arrays(doc_t, doc_w,
                                            term_keys=range(n_terms),
                                            device=lead)
    q_i = rng.integers(0, n_terms, size=(8, 4)).astype(np.int32)
    q_w = rng.integers(1, 50, size=(8, 4)).astype(np.float32)
    s_mesh, _ = impact.search_encoded(q_i, q_w, 5, mesh=mesh,
                                      backend="taat")
    s_ref, _ = impact.search_encoded(q_i, q_w, 5, backend="matmul")
    assert s_mesh == s_ref, "sharded TAAT scores != single-replica matmul"
    reps = rng.normal(size=(n_docs, 32)).astype(np.float32)
    reps /= np.linalg.norm(reps, axis=1, keepdims=True)
    dense = DenseFlatIndex(device=lead)
    dense.add(reps, impact.doc_ids)
    dv, di = dense.search(reps[:6], 3, mesh=mesh)
    assert np.asarray(di)[np.arange(6), 0].tolist() == list(range(6)), \
        "sharded dense MIPS self-retrieval failed"
    dense8 = DenseFlatIndex(dtype=torch.int8, device=lead)
    dense8.add(reps, impact.doc_ids)
    _, di8 = dense8.search(reps[:6], 3, mesh=mesh)
    assert np.asarray(di8)[np.arange(6), 0].tolist() == list(range(6)), \
        "sharded int8 (SQ8) MIPS self-retrieval failed"
    ann = DenseANNIndex(rank=32, candidates=n_docs, device=lead)
    ann.add(reps, impact.doc_ids)
    av, ai = ann.search(reps[:6], 3, mesh=mesh)
    assert np.asarray(ai)[np.arange(6), 0].tolist() == list(range(6)), \
        "sharded ANN self-retrieval failed"
    np.testing.assert_allclose(np.asarray(av), np.asarray(dv), rtol=1e-5,
                               err_msg="sharded ANN scores != exact MIPS")

    # 4. the mesh's fused hybrid search against the unsharded one
    q_reps = rng.normal(size=(8, 32)).astype(np.float32)
    f_mesh = FusedHybridSearcher(dense, impact, alpha=0.4, mesh=mesh)
    f_one = FusedHybridSearcher(dense, impact, alpha=0.4, backend="matmul")
    m_s, _ = f_mesh.search_encoded(q_reps, q_i, q_w, 5, out_depth=10)
    o_s, _ = f_one.search_encoded(q_reps, q_i, q_w, 5, out_depth=10)
    for a, b in zip(m_s, o_s):
        np.testing.assert_allclose(a, b, atol=1e-5,
                                   err_msg="mesh fused hybrid != single")

    # 5. a dp x pp pipelined contrastive step (full params, Adam)
    pipe = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    pp_mesh = pp.make_pp_mesh(pipe, n_devices // pipe, devices=devices)
    lcfg = llama.LlamaConfig(vocab_size=256, hidden_size=32,
                             num_layers=pipe, num_heads=4, num_kv_heads=2,
                             intermediate_size=64)
    lgen = torch.Generator(device=lead).manual_seed(3)
    lparams = llama.init_params(lcfg, lgen, lead, torch.float32)
    stacked = pp.stack_block_params(lparams["blocks"])
    rest = {k: v for k, v in lparams.items() if k != "blocks"}
    pp_dp = pp_mesh.shape[DATA_AXIS]
    p_b, p_t = max(4, 2 * pp_dp), 16
    a_ids = torch.from_numpy(rng.integers(
        1, lcfg.vocab_size, size=(p_b, p_t))).to(lead)
    b_ids = torch.roll(a_ids, 1, dims=1)
    pmask = torch.ones((p_b, p_t), dtype=torch.int32, device=lead)
    leaves = [x.detach().clone().requires_grad_(True) for x in
              lora.tree_leaves((stacked, rest))]
    st, rs = _unflatten((stacked, rest), iter(leaves))
    pr = {"final_norm": rs["final_norm"], "blocks": []}
    ya = pp.apply_pipelined(pr, llama.embed_tokens(rs, a_ids), pmask, lcfg,
                            pp_mesh, 2, stacked=st)
    yb = pp.apply_pipelined(pr, llama.embed_tokens(rs, b_ids), pmask, lcfg,
                            pp_mesh, 2, stacked=st)
    pp_loss = info_nce_loss(ya.mean(dim=1), yb.mean(dim=1), tau=0.1)
    opt = torch.optim.Adam(leaves, lr=1e-3)
    opt.zero_grad()
    pp_loss.backward()
    opt.step()
    pp_l = float(pp_loss.detach())
    assert np.isfinite(pp_l), f"non-finite pipeline-parallel loss: {pp_l}"

    # 6. dp x pp x tp against the sequential decoder
    pp3_note = "dp x pp x tp leg skipped (needs n%8==0)"
    emb = llama.embed_tokens(lparams, a_ids)
    if n_devices % 8 == 0:
        mesh3 = pp.make_pp3_mesh(n_devices // 4, 2, 2, devices=devices)
        with torch.no_grad():
            y3 = pp.apply_pipelined_gspmd(lparams, emb, pmask, lcfg, mesh3,
                                          2)
            y_ref = llama.apply(lparams, emb, pmask, lcfg, allow_flash=False)
        np.testing.assert_allclose(
            y3.cpu().numpy(), y_ref.cpu().numpy(), atol=3e-5,
            err_msg="dp x pp x tp pipeline != sequential decoder")
        pp3_note = "dp x pp x tp pipeline parity OK"

    # 7. ring attention over the model axis against the sequential decoder
    s_t = 16 * mesh.shape[MODEL_AXIS]
    s_ids = torch.from_numpy(rng.integers(
        1, lcfg.vocab_size, size=(p_b, s_t))).to(lead)
    s_mask = torch.ones((p_b, s_t), dtype=torch.int32, device=lead)
    s_mask[0, s_t // 2:] = 0
    s_emb = llama.embed_tokens(lparams, s_ids)
    with torch.no_grad():
        sp_out = sp.apply_sequence_parallel(lparams, s_emb, s_mask, lcfg,
                                            mesh)
        sp_ref = llama.apply(lparams, s_emb, s_mask, lcfg,
                             allow_flash=False)
    np.testing.assert_allclose(
        sp_out.cpu().numpy(), sp_ref.cpu().numpy(), atol=3e-5,
        err_msg="sequence-parallel decoder != sequential")

    # 8. the expert-parallel MoE forward and gradients
    ecfg = ep.MoEConfig(num_experts=2 * mesh.shape[MODEL_AXIS], top_k=2)
    egen = torch.Generator(device=lead).manual_seed(5)
    eparams = ep.moe_init(egen, 32, 48, ecfg, device=lead)
    ex = torch.from_numpy(rng.normal(size=(4 * data_parallel, 8, 32))
                          .astype(np.float32)).to(lead)
    with torch.no_grad():
        y_eref, _ = ep.moe_ffn(ex, eparams, ecfg)
    e_sharded = ep.shard_moe_params(eparams, mesh)
    e_leaves = [e_sharded["router"].requires_grad_(True)] + [
        t.requires_grad_(True) for k in ("gate", "up", "down")
        for t in e_sharded[k].pieces]
    y_ep, aux = ep.moe_ffn(ex, e_sharded, ecfg)
    ep_l = (y_ep ** 2).mean() + ecfg.aux_loss_coef * aux
    ep_g = torch.autograd.grad(ep_l, e_leaves)
    np.testing.assert_allclose(y_ep.detach().cpu().numpy(),
                               y_eref.cpu().numpy(), atol=1e-5,
                               err_msg="expert-parallel MoE != unsharded")
    assert np.isfinite(float(ep_l.detach())), "non-finite MoE loss"
    for g in ep_g:
        assert bool(torch.isfinite(g).all()), "non-finite MoE gradient"

    line = (f"dryrun_multichip({n_devices}, {device}): mesh="
            f"{dict(mesh.shape)} zero1+tp loss={loss:.4f} ({zero1} moments "
            f"split), fsdp-full loss={fsdp_loss:.4f} ({n_sharded} param "
            f"leaves data-sharded), sharded TAAT+MIPS (f32+int8+ANN) parity "
            f"OK, mesh fused-hybrid parity OK, dp{n_devices // pipe}xpp"
            f"{pipe} pipelined step loss={pp_l:.4f}, {pp3_note}, "
            f"seq-parallel ring-attention parity OK, expert-parallel MoE "
            f"(E={ecfg.num_experts} over model axis) parity OK")
    print(line, flush=True)
    return line


def _unflatten(tree, leaves):
    """``tree`` with its tensor leaves replaced, in order, from
    ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)

"""A contrastive LoRA fine-tuning job: ``ContrastiveTrainer.train_on_batch
(blocking=False)`` on image-caption pairs collated on the host every step,
with a host sync only on the steps ``train()`` would sync (every
``log_every``-th and every ``sync_stride``-th).

Inputs, all from ``--seed``: the model's weights and the adapters' first
values (``A ~ N(0, 1) / r``, ``B = 0``, ``scale = alpha / r``), drawn on
the card, handed to the port and the reference alike; a pool of decoded
images at the mix's COCO / Flickr30k sizes; captions of the serving mix's
lengths (every seed the same lengths in its own order). Step ``s`` takes
the pool's images ``4s .. 4s + 3`` in turn, so every seed's steps have the
same tiles and prompt lengths, and every step's rows differ.

Set-up builds the trainer once and drives it through its first three
steps by the window's own call and feed; the window then runs whole
cycles of steps through the mix's image sizes until ``--seconds`` have
passed, and waits for the card (a heavy and a light step alternate: a
window of a half cycle more would weigh them unequally). ``train_tokens_per_s``
counts the real prompt tokens (caption and image prompts) of the window's
steps over the window. The check runs the float32 reference through the
same three steps from the same adapters and compares, leaf by leaf, the
loss of each step (``loss_gap``: the largest relative gap), the first
step's gradient as the optimizer got it (``grad_gap``: worked out from its
first moment after one step; the gap of the norms against the larger of
the reference leaf's norm and the median leaf's) and the adapters' change
after three steps (``change_gap``, the same measure). Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of the second and third (``B = 0`` leaves ``A`` and ``scale`` without
a first-step gradient).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from portbench import archs, core, flops, lexicon, peaks, runtime
from portbench import trace as T
from portbench import weights as W
from portbench.kinds.index_images import make_pool
from portbench.reference import decoder as RD
from portbench.reference import image as RI
from portbench.reference import strict_f32
from portbench.reference import text as RT
from portbench.reference import train as RTR
from portbench.reference import vision as RV
from portbench.reference.quant import Linear

CHECKED_STEPS = 3


@dataclass
class State:
    ctx: core.RunContext
    lex: List[str]
    tok: object
    arch: object
    params: dict
    adapters: dict
    pool: List[np.ndarray]
    captions: List[str]
    trainer: object = None
    collate: object = None
    first: dict = field(default_factory=dict)


def draw_adapters(params: dict, rank: int, alpha: float, seed: int,
                  device) -> dict:
    """The adapters' first values, ``A`` drawn in one call."""
    targets = RTR.TARGETS
    blocks = params["text"]["blocks"]
    shapes = [(blk[n]["w"].shape[0], blk[n]["w"].shape[1])
              for blk in blocks for n in targets]
    total = sum(i * rank for i, _ in shapes)
    g = runtime.generator(seed, 4, device)
    buf = torch.randn(total, generator=g, device=device) / rank
    out, off, k = [], 0, 0
    for blk in blocks:
        entry = {}
        for n in targets:
            i, o = shapes[k]
            k += 1
            entry[n] = {"a": buf[off:off + i * rank].view(i, rank).clone(),
                        "b": torch.zeros((rank, o), device=device),
                        "scale": torch.tensor(alpha / rank, device=device)}
            off += i * rank
        out.append(entry)
    return {"text": {"blocks": out}}


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.detach().clone()


def recipe(ctx) -> dict:
    return dict(ctx.mix["recipe"])


def setup(ctx: core.RunContext) -> State:
    from mllm_sparse_retrieval_tpu_torch.configs import TrainConfig
    from mllm_sparse_retrieval_tpu_torch.train.trainer import (
        ContrastiveTrainer, make_collator)

    mix = ctx.mix
    lex = lexicon.synthetic_lexicon(runtime.rng(ctx.seed, 1),
                                    mix["lexicon_words"])
    tok = lexicon.build_tokenizer(lex)
    arch = archs.port_arch(ctx.config, tok.special_ids)
    params = W.draw(arch, runtime.sub_seed(ctx.seed, 2), ctx.device)
    r = recipe(ctx)
    adapters = draw_adapters(params, r["lora_rank"], r["lora_alpha"],
                             ctx.seed, ctx.device)
    cw = mix["caption_words"]
    n = mix["pairs"] * mix["max_steps"]
    lens = lexicon.caption_lengths(n, cw["lo"], cw["hi"], cw["median"],
                                   cw["sigma"], runtime.rng(ctx.seed, 10))
    caps = lexicon.captions(runtime.rng(ctx.seed, 11), lex, lens)
    st = State(ctx, lex, tok, arch, params, clone(adapters),
               make_pool(ctx), caps)
    cfg = TrainConfig(learning_rate=r["learning_rate"], tau=r["tau"],
                      lora_rank=r["lora_rank"], lora_alpha=r["lora_alpha"],
                      lora_dropout=r["lora_dropout"],
                      weight_decay=r["weight_decay"],
                      max_grad_norm=r["max_grad_norm"], remat=r["remat"],
                      seed=int(ctx.seed))
    st.trainer = ContrastiveTrainer(params, arch, adapters, cfg,
                                    device=ctx.device)
    pool = st.pool
    st.collate = make_collator(tok, archs.template(ctx.config), arch,
                               pixel_loader=lambda ex: pool[int(ex.img_id)])
    return st


def step_examples(st: State, s: int):
    from mllm_sparse_retrieval_tpu_torch.data.karpathy import Example

    k = st.ctx.mix["pairs"]
    return [Example(text=st.captions[(s * k + j) % len(st.captions)],
                    image_path="", text_id=str(s * k + j),
                    img_id=str((s * k + j) % len(st.pool)))
            for j in range(k)]


@dataclass
class Steps:
    tokens: int = 0
    steps: int = 0
    enqueue_s: List[float] = field(default_factory=list)
    lengths: List[List[int]] = field(default_factory=list)  # image prompts
    text_lengths: List[List[int]] = field(default_factory=list)
    image_tokens: List[int] = field(default_factory=list)


def cycle(st: State) -> int:
    """Steps until the pairs have gone once through the mix's image sizes
    (the steps' tiles and tokens repeat with this period)."""
    k, n = st.ctx.mix["pairs"], len(st.ctx.mix["image_sizes"])
    return math.lcm(k, n) // k


def run_steps(st: State, first: int, until: float, out: Steps,
              count: int = 0, on_step=None) -> int:
    """Steps from ``first`` until the clock passes ``until`` at the end of
    a whole ``cycle`` (or ``count`` steps): collate on the host, enqueue
    the step, sync where ``train()`` would. Returns the next step's
    index."""
    tr = st.trainer
    stride = tr._sync_stride()
    log_every = st.ctx.mix["log_every"]
    period = cycle(st)
    s = first
    while (count and s < first + count) or (
            not count and (time.perf_counter() < until
                           or (s - first) % period)):
        batch = st.collate(step_examples(st, s))
        t0 = time.perf_counter()
        loss = tr.train_on_batch(batch, blocking=False)
        out.enqueue_s.append(time.perf_counter() - t0)
        out.tokens += int(batch.text_mask.sum() + batch.image_mask.sum())
        out.lengths.append(batch.image_mask.sum(1).tolist())
        out.text_lengths.append(batch.text_mask.sum(1).tolist())
        out.image_tokens.append(int(
            (batch.image_ids == st.arch.image_token_id).sum()))
        out.steps += 1
        if on_step is not None:
            on_step(s, loss)
        s += 1
        if s % log_every == 0 or s % stride == 0:
            float(loss)
    return s


# ---- the check ---------------------------------------------------------------

def reference_batches(st: State, steps: int):
    """The first ``steps`` batches as the reference collates them: token
    ids by its own rules, image features of the frozen tower in the
    prompts' placeholder slots."""
    ctx = st.ctx
    cfg, dev = ctx.config, ctx.device
    vocab = RT.WordPieces(lexicon.vocabulary_words(st.lex),
                          lexicon.CHAT_SPECIALS)
    tpl = cfg["template"]
    img_id = int(cfg[cfg["special_tokens"]["image_token_id"]["key"]])
    v = cfg["vision_config"]
    grid = v["image_size"] // v["patch_size"]
    per_tile = int(grid * cfg["downsample_ratio"]) ** 2
    longest = len(vocab.encode(RT.image_prompt(
        tpl, per_tile * (cfg["max_dynamic_patch"] + 1))))
    i_pad = -(-longest // 512) * 512 if longest >= 1024 else longest
    i_pad = -(-i_pad // 16) * 16
    tp = st.params["text"]
    out = []
    for s in range(steps):
        exs = step_examples(st, s)
        rows = [vocab.encode(RT.text_prompt(tpl, e.text)) for e in exs]
        t_pad = -(-max(len(r) for r in rows) // 16) * 16
        t_ids, t_mask = RT.right_pad(rows, t_pad, vocab.pad_id)
        t_ids = torch.as_tensor(t_ids, device=dev)
        feats, rows = [], []
        with torch.no_grad():
            for e in exs:
                tiles = RI.internvl_tiles(st.pool[int(e.img_id)],
                                          v["image_size"],
                                          cfg["max_dynamic_patch"],
                                          cfg["use_thumbnail"])
                f = RV.internvl_features(
                    st.params, cfg, torch.as_tensor(tiles, device=dev),
                    Linear())
                feats.append(f)
                rows.append(vocab.encode(RT.image_prompt(tpl,
                                                         f.shape[0])))
        i_ids, i_mask = RT.right_pad(rows, i_pad, vocab.pad_id)
        i_ids = torch.as_tensor(i_ids, device=dev)
        i_emb = tp["embed"][i_ids].float()
        for j, f in enumerate(feats):
            slots = i_ids[j] == img_id
            i_emb[j, slots] = f
        out.append((tp["embed"][t_ids].float(),
                    torch.as_tensor(t_mask, device=dev), t_pad, i_emb,
                    torch.as_tensor(i_mask, device=dev), i_pad))
    return out


def leaf_gaps(got: List[torch.Tensor], ref: List[torch.Tensor],
              gate: List[float]) -> float:
    """The largest gap of leaf norms, over the leaves whose ``gate`` (the
    reference's gradient norm) is at least a thousandth of the median
    positive gate, against the larger of the reference leaf's norm and the
    median leaf's."""
    gates = np.array(gate)
    pos = gates[gates > 0]
    if not pos.size:
        return math.inf
    keep = gates >= 1e-3 * np.median(pos)
    gn = np.array([float(x.double().norm()) for x in got])
    rn = np.array([float(x.double().norm()) for x in ref])
    med = np.median(rn[keep])
    return float(np.max(np.abs(gn - rn)[keep]
                        / np.maximum(rn[keep], med)))


def reference_readings(st: State, lin: Linear):
    """(losses, first gradients, adapters after the checked steps) of the
    reference's run."""
    strict_f32()
    dims = RD.TextDims.from_config(st.ctx.config)
    batches = reference_batches(st, CHECKED_STEPS)
    return RTR.train_steps(st.params["text"], st.adapters, dims, batches,
                           recipe(st.ctx), int(st.ctx.seed), lin)


def compare(st: State, losses, g1, after, ref) -> List[core.Check]:
    r_losses, r_grads, r_after = ref
    loss_gap = max(abs(a - b) / max(abs(b), 1e-12)
                   for a, b in zip(losses, r_losses))
    before = RTR.leaves(st.adapters)
    gate1 = [float(g.double().norm()) for g in r_grads[0]]
    gate = [max(float(g[i].double().norm()) for g in r_grads)
            for i in range(len(before))]
    grad_gap = leaf_gaps(g1, r_grads[0], gate1)
    change_gap = leaf_gaps([a - b.float() for a, b in zip(after, before)],
                           [a - b.float() for a, b in zip(r_after, before)],
                           gate)
    lim = st.ctx.limits
    return [core.Check("loss_gap", loss_gap, lim["loss_gap"]),
            core.Check("grad_gap", grad_gap, lim["grad_gap"]),
            core.Check("change_gap", change_gap, lim["change_gap"])]


# ---- the run -----------------------------------------------------------------

def first_steps(st: State) -> None:
    """The checked steps, by the window's call and feed: their losses,
    the first step's gradients (from the first moment) and the adapters
    after them, kept without a host sync."""
    from mllm_sparse_retrieval_tpu_torch.train import trainer as TR

    losses = []

    def keep(s, loss):
        losses.append(loss)
        if s == 0:
            st.first["g1"] = [m.detach().clone() / (1 - TR.ADAM_B1)
                              for m in st.trainer.opt_state["mu"]]
        if s == CHECKED_STEPS - 1:
            st.first["after"] = [x.detach().clone()
                                 for x in st.trainer._leaves()]

    run_steps(st, 0, 0.0, Steps(), count=CHECKED_STEPS, on_step=keep)
    st.first["losses"] = losses


def model_flops(st: State, steps: Steps) -> float:
    """Model FLOPs of the steps: the decoder forward and its input
    gradients over both prompts' real tokens (twice the forward), the LoRA
    paths forward and backward, the frozen vision tower forward on the
    real tiles; no LM head, no base-weight gradient, no recompute."""
    cfg, r = st.ctx.config, recipe(st.ctx)
    v = cfg["vision_config"]
    grid = v["image_size"] // v["patch_size"]
    per_tile = int(grid * cfg["downsample_ratio"]) ** 2
    total = 0.0
    for s in range(steps.steps):
        lengths = steps.lengths[s] + steps.text_lengths[s]
        total += 2 * flops.decoder_forward(cfg, lengths, head=False)
        total += flops.lora_train(cfg, lengths, r["lora_rank"])
        total += flops.internvit(cfg, steps.image_tokens[s] // per_tile)
    return total


def run(ctx: core.RunContext) -> core.Outcome:
    st = setup(ctx)
    first_steps(st)
    runtime.sync(ctx.device)
    runtime.reset_peak(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start
    win = Steps()
    t0 = time.perf_counter()
    nxt = run_steps(st, CHECKED_STEPS, t0 + ctx.seconds, win)
    runtime.sync(ctx.device)
    window_s = time.perf_counter() - t0
    peak = runtime.peak_bytes(ctx.device)
    layer = traced_step(st, nxt, win, window_s) if ctx.trace else None
    losses = [float(x) for x in st.first["losses"]]
    g1, after = st.first["g1"], st.first["after"]
    st.trainer = st.collate = None
    runtime.release(ctx.device)
    t_ref = time.perf_counter()
    chk = compare(st, losses, g1, after, reference_readings(st, Linear()))
    notes = [f"window: {win.steps} steps in {window_s:.3f} s, "
             f"{win.tokens} real tokens; enqueue "
             f"{np.mean(win.enqueue_s) * 1e3:.1f} ms a step; losses "
             f"{losses}; reference in {time.perf_counter() - t_ref:.2f} s"]
    out = core.Outcome(attempted=win.steps + CHECKED_STEPS, failed=0,
                       e2e={"train_tokens_per_s": win.tokens / window_s,
                            "setup_s": setup_s},
                       checks=chk, memory_peak_bytes=peak, notes=notes)
    if layer is not None:
        tr = layer["trace"]
        out.busy_s = tr.busy_s()
        out.window_s = tr.window_s
        out.breakdown = {"device_ops": tr.device_ops(),
                         "idle_gaps": tr.idle_gaps()}
        out.layer = layer
        out.notes += layer["notes"]
    return out


def traced_step(st: State, s: int, win: Steps, window_s: float) -> dict:
    """One more step on the card alone under the profiler, after the
    window (the first of a cycle, as every window's is), and what the
    window's own clocks give."""
    from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA

    ctx = st.ctx
    one = Steps()
    FA.reset_launch_count()
    _, tr = T.profiled(lambda: run_steps(st, s, 0.0, one, count=1),
                       lambda: runtime.sync(ctx.device), host=False)
    t = archs.text_config(ctx.config)
    heads, kv = t["num_attention_heads"], t["num_key_value_heads"]
    dh = t["hidden_size"] // heads
    lengths = one.lengths[0]
    t_pad = int(st.collate(step_examples(st, s)).image_mask.shape[1])
    bounds = {}
    for kernel, fn in (("fwd", peaks.flash_fwd_bound),
                       ("dq", peaks.flash_dq_bound),
                       ("dkv", peaks.flash_dkv_bound)):
        bounds[kernel] = [fn(lengths, t_pad, heads, kv, dh)] \
            * FA.launch_count(kernel)
    names = {"fwd": "flash_fwd", "dq": "flash_bwd_dq", "dkv": "flash_bwd_dkv"}
    notes = []
    for k, name in names.items():
        n = tr.kernel_s(name)[1]
        if n != FA.launch_count(k):
            notes.append(f"trace: {n} {name} kernels in the profile, "
                         f"{FA.launch_count(k)} launches counted")
    return {"trace": tr, "flash_bounds_s": bounds, "flash_names": names,
            "enqueue_s": win.enqueue_s,
            "window_flops": model_flops(st, win), "window_s": window_s,
            "peak_flops": peaks.BF16_OPS_PER_S, "notes": notes}


def control(ctx: core.RunContext) -> dict:
    """The control's numbers: the float8 reference's three steps judged by
    the float32 reference's."""
    st = setup(ctx)
    st.trainer = st.collate = None
    runtime.release(ctx.device)
    ref = reference_readings(st, Linear())
    c_losses, c_grads, c_after = reference_readings(st, Linear(fp8=True))
    chk = compare(st, c_losses, c_grads[0], c_after, ref)
    return {c.name: c.value for c in chk}

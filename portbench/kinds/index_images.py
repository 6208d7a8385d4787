"""Building a corpus index offline: images through
``pipelines.encode.encode_examples(encode_type="image")`` in its default
batches of 8, host preprocessing on its prefetch thread.

Inputs, all from ``--seed``: the model's weights (on the card) and a pool
of decoded images (uint8 values as float arrays in memory, drawn on the
card), cycling through the mix's COCO / Flickr30k sizes. The window runs
``encode_examples`` over chunks of ``chunk_batches`` batches until
``--seconds`` have passed; ``images_per_s`` is the images of the chunks
done over the time they took (every image's dense vector and terms are on
the host when its chunk returns). The check runs the plain reference over
a seeded sample of the window's images, the one with the most image
tokens always in it, and compares each image's dense vector
(``dense_gap``: the norm of the difference of the unit vectors) and terms
(``terms_gap``: the summed absolute weight differences over the union of
the two term sets, over the reference's summed weights).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from portbench import archs, core, flops, lexicon, peaks, runtime
from portbench import trace as T
from portbench import weights as W
from portbench.reference import image as RI
from portbench.reference import mllm as RM
from portbench.reference import strict_f32
from portbench.reference import text as RT
from portbench.reference.quant import Linear


@dataclass
class State:
    ctx: core.RunContext
    lex: List[str]
    tok: object
    arch: object
    params: dict
    pool: List[np.ndarray]
    per_shape: dict = field(default_factory=dict)


def make_pool(ctx) -> List[np.ndarray]:
    """``pool`` images of the mix's sizes in turn, uint8 values drawn on
    the device, as float32 ``[H, W, 3]`` in [0, 1] on the host."""
    g = runtime.generator(ctx.seed, 3, ctx.device)
    sizes = ctx.mix["image_sizes"]
    out = []
    for i in range(ctx.mix["pool"]):
        h, w = sizes[i % len(sizes)]
        px = torch.randint(0, 256, (h, w, 3), generator=g,
                           device=ctx.device, dtype=torch.uint8)
        out.append(px.cpu().numpy().astype(np.float32) / 255.0)
    return out


def setup(ctx: core.RunContext) -> State:
    lex = lexicon.synthetic_lexicon(runtime.rng(ctx.seed, 1),
                                    ctx.mix["lexicon_words"])
    tok = lexicon.build_tokenizer(lex)
    arch = archs.port_arch(ctx.config, tok.special_ids)
    params = W.draw(arch, runtime.sub_seed(ctx.seed, 2), ctx.device)
    return State(ctx, lex, tok, arch, params, make_pool(ctx))


def examples(n: int, offset: int):
    from mllm_sparse_retrieval_tpu_torch.data.karpathy import Example

    return [Example(text="", image_path="", text_id="",
                    img_id=str(offset + i)) for i in range(n)]


def encode(st: State, exs):
    """One ``encode_examples`` call over ``exs`` (image ids index the
    pool in turn)."""
    from mllm_sparse_retrieval_tpu_torch.configs import SparseConfig
    from mllm_sparse_retrieval_tpu_torch.pipelines.encode import (
        encode_examples)

    pool = st.pool

    def loader(ex):
        return pool[int(ex.img_id) % len(pool)]

    return encode_examples(
        exs, st.params, st.arch, st.tok, archs.template(st.ctx.config),
        encode_type="image", sparse_cfg=SparseConfig(),
        batch_size=st.ctx.mix["batch_size"], pixel_loader=loader,
        device=st.ctx.device)


def window(st: State, seconds: float, offset: int):
    """Chunks until ``seconds`` have passed: (results, images, seconds)."""
    per = st.ctx.mix["chunk_batches"] * st.ctx.mix["batch_size"]
    results, done = [], 0
    t0 = time.perf_counter()
    while True:
        results.append(encode(st, examples(per, offset + done)))
        done += per
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return results, done, elapsed


# ---- the check ---------------------------------------------------------------

def image_tokens(config: dict, image01: np.ndarray) -> int:
    v = config["vision_config"]
    if config["family"] == "qwen2_5_vl":
        _, gh, gw = RI.qwen_patches(image01, v["patch_size"],
                                    v["spatial_merge_size"],
                                    v["temporal_patch_size"],
                                    v["window_size"], config["min_pixels"],
                                    config["max_pixels"])
        m = v["spatial_merge_size"]
        return (gh // m) * (gw // m)
    n = RI.internvl_tiles(image01, v["image_size"],
                          config["max_dynamic_patch"],
                          config["use_thumbnail"]).shape[0]
    grid = v["image_size"] // v["patch_size"]
    return n * int(grid * config["downsample_ratio"]) ** 2


def window_image(st: State, i: int) -> np.ndarray:
    """The ``i``-th image of the window (after the warm-up's)."""
    warm = st.ctx.mix["warmup_batches"] * st.ctx.mix["batch_size"]
    return st.pool[(warm + i) % len(st.pool)]


def sample(st: State, n_images: int) -> List[int]:
    """A seeded sample of the window's images, the one with the most image
    tokens among its first sizes always in it."""
    k = min(st.ctx.mix["check_sample"], n_images)
    pick = set(runtime.rng(st.ctx.seed, 40).choice(
        n_images, size=k, replace=False).tolist())
    sizes = len(st.ctx.mix["image_sizes"])
    pick.add(max(range(min(sizes, n_images)), key=lambda i: image_tokens(
        st.ctx.config, window_image(st, i))))
    return sorted(pick)


def gaps(terms_got: dict, dense_got, terms_ref: dict, dense_ref):
    dense_gap = float(torch.linalg.vector_norm(
        torch.as_tensor(dense_got, dtype=torch.float32,
                        device=dense_ref.device) - dense_ref))
    union = set(terms_got) | set(terms_ref)
    diff = sum(abs(terms_got.get(t, 0) - terms_ref.get(t, 0))
               for t in union)
    return dense_gap, diff / max(1, sum(terms_ref.values()))


def reference_reps(st: State, images: List[np.ndarray], lin: Linear):
    strict_f32()
    vocab = RT.WordPieces(lexicon.vocabulary_words(st.lex),
                          lexicon.CHAT_SPECIALS)
    return [RM.encode_image(st.params, st.ctx.config, im, vocab, lin,
                            device=st.ctx.device) for im in images]


def served_terms(selected) -> dict:
    return {int(i): int(w) for i, w in zip(selected.token_ids,
                                           selected.weights) if w > 0}


def checks(st: State, got: list, images: List[np.ndarray]):
    ref = reference_reps(st, images, Linear())
    pairs = [gaps(t, d, rt, rd) for (t, d), (rt, rd) in zip(got, ref)]
    lim = st.ctx.limits
    return [core.Check("dense_gap", max(p[0] for p in pairs),
                       lim["dense_gap"]),
            core.Check("terms_gap", max(p[1] for p in pairs),
                       lim["terms_gap"])]


# ---- the traced slice --------------------------------------------------------

def prompt_and_flops(st: State, image01: np.ndarray):
    """(real prompt length, model FLOPs of the vision side) of one image,
    by the reference's rules."""
    cfg = st.ctx.config
    key = image01.shape
    cache = st.per_shape
    if key not in cache:
        v = cfg["vision_config"]
        n_tok = image_tokens(cfg, image01)
        vocab = RT.WordPieces(lexicon.vocabulary_words(st.lex),
                              lexicon.CHAT_SPECIALS)
        length = len(vocab.encode(RT.image_prompt(cfg["template"], n_tok)))
        if cfg["family"] == "qwen2_5_vl":
            _, gh, gw = RI.qwen_patches(
                image01, v["patch_size"], v["spatial_merge_size"],
                v["temporal_patch_size"], v["window_size"],
                cfg["min_pixels"], cfg["max_pixels"])
            vision = flops.qwen_vit(cfg, gh, gw)
        else:
            grid = v["image_size"] // v["patch_size"]
            per_tile = int(grid * cfg["downsample_ratio"]) ** 2
            vision = flops.internvit(cfg, n_tok // per_tile)
        cache[key] = (length, vision)
    return cache[key]


def model_flops(st: State, images) -> float:
    sizes = [prompt_and_flops(st, im) for im in images]
    return sum(v for _, v in sizes) + flops.decoder_forward(
        st.ctx.config, [n for n, _ in sizes])


def traced_slice(st: State, offset: int) -> dict:
    """One chunk under the profiler, after the window: what the
    device-side readers read."""
    from mllm_sparse_retrieval_tpu_torch.ops import flash_attention as FA

    ctx = st.ctx
    per = ctx.mix["trace_batches"] * ctx.mix["batch_size"]
    FA.reset_launch_count()
    _, tr = T.profiled(lambda: encode(st, examples(per, offset)),
                       lambda: runtime.sync(ctx.device))
    images = [st.pool[(offset + i) % len(st.pool)] for i in range(per)]
    lengths = [prompt_and_flops(st, im)[0] for im in images]
    t = archs.text_config(ctx.config)
    heads, kv = t["num_attention_heads"], t["num_key_value_heads"]
    dh = t["hidden_size"] // heads
    b, t_pad = ctx.mix["batch_size"], flash_len(st)
    bounds = [peaks.flash_fwd_bound(lengths[i:i + b], t_pad, heads, kv, dh)
              for i in range(0, per, b)
              for _ in range(t["num_hidden_layers"])]
    fwd_n = tr.kernel_s("flash_fwd")[1]
    notes = []
    if fwd_n != FA.launch_count("fwd"):
        notes.append(f"trace: {fwd_n} flash forward kernels in the "
                     f"profile, {FA.launch_count('fwd')} launches counted")
    return {"trace": tr, "images": per,
            "flash_fwd_bounds_s": bounds if fwd_n else [],
            "peak_flops": peaks.BF16_OPS_PER_S, "notes": notes}


def flash_len(st: State) -> int:
    """The padded prompt length every image batch runs at."""
    from mllm_sparse_retrieval_tpu_torch.models.api import image_input_spec

    spec = image_input_spec(st.arch)
    tpl = archs.template(st.ctx.config)
    n = len(st.tok.encode(tpl.expand_image(tpl.image_prompt(),
                                           spec.max_image_tokens)))
    n = -(-n // 512) * 512 if n >= 1024 else n
    return -(-n // 16) * 16


# ---- the run -----------------------------------------------------------------

def run(ctx: core.RunContext) -> core.Outcome:
    st = setup(ctx)
    mix = ctx.mix
    warm = mix["warmup_batches"] * mix["batch_size"]
    encode(st, examples(warm, 0))
    runtime.reset_peak(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start
    results, n_images, elapsed = window(st, ctx.seconds, warm)
    layer = None
    if ctx.trace:
        layer = traced_slice(st, warm + n_images)
        layer["window_flops"] = model_flops(
            st, [window_image(st, i) for i in range(n_images)])
        layer["window_s"] = elapsed
    peak = runtime.peak_bytes(ctx.device)
    got = []
    for res in results:
        for i in range(len(res.ids)):
            got.append((served_terms(res.selected_terms[i]), res.dense[i]))
    pick = sample(st, len(got))
    images = [window_image(st, i) for i in pick]
    sel = [got[i] for i in pick]
    del results, got
    runtime.release(ctx.device)
    t_ref = time.perf_counter()
    chk = checks(st, sel, images)
    notes = [f"window: {n_images} images over {elapsed:.3f} s "
             f"({n_images / elapsed:.3f} images/s); "
             f"reference over {len(pick)} images in "
             f"{time.perf_counter() - t_ref:.2f} s"]
    out = core.Outcome(attempted=n_images, failed=0,
                       e2e={"images_per_s": n_images / elapsed,
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


def control(ctx: core.RunContext) -> dict:
    """The control's numbers over the images a run of this seed samples
    (assuming a window of at least ``check_sample`` images)."""
    st = setup(ctx)
    pick = sample(st, max(ctx.mix["check_sample"] * 4,
                          len(ctx.mix["image_sizes"])))
    images = [window_image(st, i) for i in pick]
    ref = reference_reps(st, images, Linear())
    ctrl = reference_reps(st, images, Linear(fp8=True))
    pairs = [gaps(t, d, rt, rd) for (t, d), (rt, rd) in zip(ctrl, ref)]
    return {"dense_gap": max(p[0] for p in pairs),
            "terms_gap": max(p[1] for p in pairs)}

"""The two vision towers, in float32, one image at a time.

Qwen2.5-VL (Hugging Face's ``Qwen2_5_VisionTransformerPretrainedModel``):
a linear patch embedding without bias, merge units reordered window by
window (windows of ``window_size`` pixels, row-major, the units of each
row-major inside it), 2-D rotary positions (height and width halves of
``head_dim / 2``, theta 10,000) over ``rotate_half``, blocks of RMSNorm
(eps 1e-6), fused qkv attention within a window (over the whole image at
``fullatt_block_indexes``) and a SwiGLU MLP, all with biases; the merger's
RMSNorm, the four patches of a unit side by side, Linear, GELU, Linear;
back to the original unit order.

InternVL2.5 (``InternVisionModel`` and the chat model's ``mlp1``): a
14 px patch embedding with bias, a class token, learned positions, blocks
of LayerNorm (eps 1e-6) attention and a GELU MLP, each scaled by its layer
scale; the class token dropped, the ``ps_version`` v2 pixel shuffle at
``downsample_ratio``, LayerNorm (eps 1e-5), Linear, GELU, Linear.

The weights come in the layout the benchmark hands both sides: ``[in,
out]`` matrices, patch rows in the port's flattening (``(c, t, py, px)``
for Qwen, ``(py, px, c)`` for InternViT).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.decoder import rms_norm
from portbench.reference.quant import Linear


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _attend(q, k, v, allowed=None):
    """q / k / v ``[S, H, D]``; ``allowed`` ``[S, S]`` or None (all)."""
    s = torch.einsum("shd,thd->hst", q, k) / q.shape[-1] ** 0.5
    if allowed is not None:
        s = s.masked_fill(~allowed[None], float("-inf"))
    return torch.einsum("hst,thd->shd", torch.softmax(s, dim=-1), v)


def qwen_vit(vp: dict, vcfg: dict, patches: torch.Tensor, gh: int, gw: int,
             lin: Linear) -> torch.Tensor:
    """``[units, out_hidden]`` merged features of one image's patches
    ``[gh * gw, patch_dim]``, in the original unit order."""
    m, p = vcfg["spatial_merge_size"], vcfg["patch_size"]
    c, heads = vcfg["hidden_size"], vcfg["num_heads"]
    dh = c // heads
    unit = m * m
    lh, lw = gh // m, gw // m
    n_units, s = lh * lw, gh * gw
    dev = patches.device
    vws = vcfg["window_size"] // m // p
    index = torch.arange(n_units, device=dev).reshape(lh, lw)
    pad_h, pad_w = vws - lh % vws, vws - lw % vws
    padded = torch.full((lh + pad_h, lw + pad_w), -100, device=dev,
                        dtype=torch.long)
    padded[:lh, :lw] = index
    nwh, nww = (lh + pad_h) // vws, (lw + pad_w) // vws
    padded = padded.reshape(nwh, vws, nww, vws).permute(0, 2, 1, 3) \
        .reshape(nwh * nww, vws * vws)
    seqlens = (padded != -100).sum(1)
    flat = padded.reshape(-1)
    window_index = flat[flat != -100]
    window_of = torch.repeat_interleave(
        torch.arange(nwh * nww, device=dev), seqlens * unit)
    in_window = window_of[:, None] == window_of[None, :]

    x = lin(patches, vp["patch_embed"]["w"])
    x = x.reshape(n_units, unit, -1)[window_index].reshape(s, -1)
    dim = dh // 2
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                          device=dev) / dim))
    hpos = torch.arange(gh, device=dev)[:, None].expand(gh, gw)
    wpos = torch.arange(gw, device=dev)[None, :].expand(gh, gw)

    def unit_major(pos):
        return pos.reshape(lh, m, lw, m).permute(0, 2, 1, 3).reshape(-1)

    rot = torch.cat([unit_major(hpos)[:, None] * inv,
                     unit_major(wpos)[:, None] * inv], dim=1)
    rot = rot.reshape(n_units, unit, -1)[window_index].reshape(s, -1)
    emb = torch.cat([rot, rot], dim=-1)
    cos, sin = emb.cos().float()[:, None], emb.sin().float()[:, None]
    full = set(vcfg["fullatt_block_indexes"])
    for i, blk in enumerate(vp["blocks"]):
        y = rms_norm(x, blk["norm1"]["scale"], 1e-6)
        qkv = lin(y, blk["qkv"]["w"], blk["qkv"]["b"]).reshape(s, 3, heads,
                                                               dh)
        q, k, v = qkv.unbind(1)
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin
        o = _attend(q, k, v, None if i in full else in_window)
        x = x + lin(o.reshape(s, c), blk["proj"]["w"], blk["proj"]["b"])
        y = rms_norm(x, blk["norm2"]["scale"], 1e-6)
        g = lin(y, blk["gate"]["w"], blk["gate"]["b"])
        x = x + lin(F.silu(g) * lin(y, blk["up"]["w"], blk["up"]["b"]),
                    blk["down"]["w"], blk["down"]["b"])
    mp = vp["merger"]
    y = rms_norm(x, mp["ln_q"]["scale"], 1e-6).reshape(n_units, unit * c)
    y = lin(F.gelu(lin(y, mp["fc1"]["w"], mp["fc1"]["b"])), mp["fc2"]["w"],
            mp["fc2"]["b"])
    return y[torch.argsort(window_index)]


def _layer_norm(x, p, eps):
    return F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(),
                        p["bias"].float(), eps)


def internvl_features(params: dict, config: dict, tiles: torch.Tensor,
                      lin: Linear) -> torch.Tensor:
    """``[n * tokens_per_tile, text_hidden]`` features of one image's
    ``[n, S, S, 3]`` normalised tiles, tile after tile."""
    vp, vcfg = params["vision"], config["vision_config"]
    p, c = vcfg["patch_size"], vcfg["hidden_size"]
    heads = vcfg["num_attention_heads"]
    eps = vcfg["layer_norm_eps"]
    n, size = tiles.shape[0], tiles.shape[1]
    g = size // p
    patches = tiles.float().reshape(n, g, p, g, p, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(n, g * g, p * p * 3)
    x = lin(patches, vp["patch_embed"]["w"], vp["patch_embed"]["b"])
    cls = vp["cls_token"].float().expand(n, 1, c)
    x = torch.cat([cls, x], dim=1) + vp["pos_embed"].float()[None]
    s = x.shape[1]
    for blk in vp["blocks"]:
        y = _layer_norm(x, blk["norm1"], eps)
        q, k, v = (lin(y, blk[n_]["w"], blk[n_]["b"]).reshape(
            n, s, heads, c // heads) for n_ in ("q", "k", "v"))
        o = torch.stack([_attend(q[i], k[i], v[i]) for i in range(n)])
        x = x + lin(o.reshape(n, s, c), blk["proj"]["w"],
                    blk["proj"]["b"]) * blk["lambda1"].float()
        y = _layer_norm(x, blk["norm2"], eps)
        y = F.gelu(lin(y, blk["fc1"]["w"], blk["fc1"]["b"]))
        x = x + lin(y, blk["fc2"]["w"], blk["fc2"]["b"]) \
            * blk["lambda2"].float()
    x = x[:, 1:].reshape(n, g, g, c)
    r = config["downsample_ratio"]
    x = x.reshape(n, g, int(g * r), int(c / r)).permute(0, 2, 1, 3)
    x = x.reshape(n, int(g * r), int(g * r), int(c / (r * r)))
    x = x.permute(0, 2, 1, 3).reshape(n, -1, int(c / (r * r)))
    pj = params["projector"]
    y = _layer_norm(x, pj["ln"], 1e-5)
    y = lin(F.gelu(lin(y, pj["fc1"]["w"], pj["fc1"]["b"])), pj["fc2"]["w"],
            pj["fc2"]["b"])
    return y.reshape(-1, y.shape[-1])

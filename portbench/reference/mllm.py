"""An image's representation by the plain model: its prompt with the
image's features in the placeholder slots, the decoder (M-RoPE positions
for Qwen2.5-VL as Hugging Face's ``get_rope_index`` gives them: the text
before the image counts up, the image's tokens take (0, row, column)
offset by it, the text after resumes past the largest), and the reps at
the last position: the dense vector and the top ``k`` vocabulary terms
with ``round(100 * w)`` weights."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from portbench.reference import decoder as RD
from portbench.reference import image as RI
from portbench.reference import text as RT
from portbench.reference import vision as RV
from portbench.reference.quant import Linear


def image_token_id(config: dict) -> int:
    return int(config[config["special_tokens"]["image_token_id"]["key"]])


def mrope_positions(ids, image_id: int, lh: int, lw: int) -> torch.Tensor:
    """``[3, T]`` positions of one prompt holding one image of ``lh x lw``
    merged tokens."""
    ids = list(ids)
    start = ids.index(image_id)
    before = torch.arange(start)[None].expand(3, start)
    img = torch.stack([torch.zeros(lh * lw, dtype=torch.long),
                       torch.arange(lh).repeat_interleave(lw),
                       torch.arange(lw).repeat(lh)]) + start
    rest = len(ids) - start - lh * lw
    after = torch.arange(rest)[None].expand(3, rest) + img.max() + 1
    return torch.cat([before, img, after], dim=1)


def encode_image(params: dict, config: dict, image01: np.ndarray,
                 vocab: RT.WordPieces, lin: Linear, k: int = 128,
                 device="cuda") -> Tuple[Dict[int, int], torch.Tensor]:
    """(terms {id: weight > 0}, dense ``[H]``) of one raw image."""
    dims = RD.TextDims.from_config(config)
    vcfg = config["vision_config"]
    img_id = image_token_id(config)
    if config["family"] == "qwen2_5_vl":
        patches, gh, gw = RI.qwen_patches(
            image01, vcfg["patch_size"], vcfg["spatial_merge_size"],
            vcfg["temporal_patch_size"], vcfg["window_size"],
            config["min_pixels"], config["max_pixels"])
        feats = RV.qwen_vit(params["vision"], vcfg,
                            torch.as_tensor(patches, device=device), gh, gw,
                            lin)
        m = vcfg["spatial_merge_size"]
        lh, lw = gh // m, gw // m
        n_tok = lh * lw
    else:
        tiles = RI.internvl_tiles(image01, vcfg["image_size"],
                                  config["max_dynamic_patch"],
                                  config["use_thumbnail"])
        feats = RV.internvl_features(
            params, config, torch.as_tensor(tiles, device=device), lin)
        n_tok = feats.shape[0]
    ids = vocab.encode(RT.image_prompt(config["template"], n_tok))
    ids_t = torch.as_tensor(ids, device=device)
    tp = params["text"]
    emb = tp["embed"][ids_t].float()
    slots = ids_t == img_id
    if int(slots.sum()) != feats.shape[0]:
        raise ValueError(f"{int(slots.sum())} image slots for "
                         f"{feats.shape[0]} features")
    emb[slots] = feats
    if dims.mrope is not None:
        pos = mrope_positions(ids, img_id, lh, lw).to(device)[:, None]
    else:
        pos = torch.arange(len(ids), device=device)[None]
    mask = torch.ones((1, len(ids)), dtype=torch.long, device=device)
    hidden = RD.decoder(tp, dims, emb[None], mask, pos, lin)
    sparse, dense = RD.reps(tp, dims, hidden, mask, lin)
    vals, idx = torch.topk(sparse[0], k)
    w = np.rint(vals.double().cpu().numpy() * 100.0).astype(np.int64)
    terms = {int(i): int(x) for i, x in zip(idx.tolist(), w) if x > 0}
    return terms, dense[0]

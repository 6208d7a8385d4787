"""PyTorch port, InternVL's staged tiling (``ops/tile_kernel.py``) on the
CPU: the plain PyTorch version of the card's tile kernel, run on the same
staged buffer and tables the kernel takes, against the numpy tiling of
``data/tiling.py`` (``dynamic_tile`` + ``pad_tiles``, which
``test_torch_internvl.py`` holds byte-equal to the JAX package's), byte for
byte; the staged host plan's tile and prompt-token counts against the
numpy path's; row slices of a staged batch against slices of the stacked
numpy tiles. No JAX. The kernel itself runs in ``test_torch_cuda.py``.

Sizes: the index mix's eight COCO / Flickr30k sizes (612 x 612 is one tile
and no thumbnail), an upscale (20 x 30), a large downscale (3,000 x 4,000)
and extreme aspect ratios (40 x 1,000, 1,000 x 40); 448 x 896 and 448 x
448 skip the horizontal pass of both of their resizes.
"""

import numpy as np
import pytest
import torch

from mllm_sparse_retrieval_tpu_torch import tracing
from mllm_sparse_retrieval_tpu_torch.data.tiling import (
    dynamic_tile, pad_tiles)
from mllm_sparse_retrieval_tpu_torch.models import api
from mllm_sparse_retrieval_tpu_torch.models.internvl import (
    InternViTConfig, InternVLConfig)
from mllm_sparse_retrieval_tpu_torch.models.llama import LlamaConfig
from mllm_sparse_retrieval_tpu_torch.ops import tile_kernel as T

MIX = [(480, 640), (640, 480), (375, 500), (500, 375), (333, 500),
       (500, 333), (427, 640), (612, 612)]
EDGES = [(20, 30), (3000, 4000), (40, 1000), (1000, 40), (448, 896),
         (448, 448)]


def images(sizes, seed=0):
    """Decoded images as the loaders give them: uint8 values over 255 as
    float32 ``[H, W, 3]``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, hw + (3,), dtype=np.uint8).astype(
        np.float32) / 255.0 for hw in sizes]


def numpy_tiles(ims, tile=448, max_num=12):
    return np.stack([pad_tiles(dynamic_tile(im, tile, max_num=max_num),
                               max_num + 1)[0] for im in ims])


def internvl_arch(tile, max_num):
    return InternVLConfig(
        vision=InternViTConfig(hidden_size=32, num_layers=1, num_heads=4,
                               intermediate_size=64, image_size=tile),
        text=LlamaConfig(vocab_size=128, hidden_size=64, num_layers=1,
                         num_heads=4, num_kv_heads=2, intermediate_size=128),
        image_token_id=120, max_dynamic_tiles=max_num)


@pytest.mark.parametrize("hw", MIX + EDGES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_plain_version_equals_the_numpy_tiling(hw):
    ims = images([hw], seed=hw[0] * 7 + hw[1])
    got = T.tile_images(*T.stage(ims, 448, 12).packed("cpu"))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == numpy_tiles(ims).tobytes()


def test_plain_version_equals_the_numpy_tiling_on_a_mixed_batch():
    """The index mix's eight sizes and two edges in one staged buffer
    (13, 7 and 1 tiles; a skipped horizontal pass beside resampled ones),
    an image object given twice as a pad row is."""
    ims = images(MIX + [(20, 30), (448, 896)], seed=5)
    ims.append(ims[-1])
    staged = T.stage(ims, 448, 12)
    assert sorted(set(staged.n_tiles)) == [1, 3, 7, 13]
    got = T.tile_images(*staged.packed("cpu"))
    assert got.numpy().tobytes() == numpy_tiles(ims).tobytes()


@pytest.mark.parametrize("tile,max_num", [(56, 4), (448, 12)])
def test_staged_plan_counts_equal_the_numpy_path(tile, max_num):
    """The InternVL spec's ``stage`` against its ``preprocess_example`` +
    ``batch_vision``: the same tile counts, prompt token counts and (made
    on the host) tiles; ``batch_images`` takes ``stage``."""
    arch = internvl_arch(tile, max_num)
    spec = api.image_input_spec(arch)
    ims = images(MIX + [(20, 30), (40, 1000)], seed=2)
    staged, counts = spec.stage(ims)
    items = [spec.preprocess_example(im) for im in ims]
    assert counts == [n for _, n in items]
    assert staged.n_tiles == [n // arch.num_image_tokens for _, n in items]
    assert staged.shape == (len(ims), max_num + 1, tile, tile, 3)
    want = spec.batch_vision([it for it, _ in items])
    assert np.asarray(staged).tobytes() == want.tobytes()
    again, again_counts = api.batch_images(spec, ims)
    assert isinstance(again, T.StagedTiles) and again_counts == counts


def test_row_slices_equal_slices_of_the_numpy_tiles():
    """``staged[lo:hi]`` made by the plain version, by ``to("cpu")`` (the
    numpy path: no ``tile`` span, no launch) and on the host equals rows
    ``lo:hi`` of the whole batch's numpy tiles."""
    ims = images(MIX, seed=9)
    staged = T.stage(ims, 56, 4)
    want = numpy_tiles(ims, 56, 4)
    T.reset_launch_count()
    tracing.clear()
    tracing.enable()
    try:
        for lo, hi in ((0, 8), (0, 3), (3, 8), (5, 6)):
            part = staged[lo:hi]
            assert len(part) == hi - lo
            assert T.tile_images(*part.packed("cpu")).numpy().tobytes() == \
                want[lo:hi].tobytes()
            assert part.to("cpu").numpy().tobytes() == want[lo:hi].tobytes()
            assert np.asarray(part).tobytes() == want[lo:hi].tobytes()
    finally:
        tracing.disable()
    assert T.launch_count() == 0
    assert not [s for s in tracing.spans() if s.name == "tile"]


def test_plan_tables_hold_pillows_weights():
    """The tables the kernel reads: ImageNet's mean and std as f32 bits,
    one horizontal job a resize whose width changes, a vertical job a tile
    slot (padding slots dead), each table row summing to about 1.0 in
    Pillow's 22-bit fixed point, and an unchanged size's rows exactly one
    1.0."""
    layout = T.plan([(480, 640), (612, 612), (448, 896)],
                    [(4, 3), (1, 1), (2, 1)], 448, 13)
    tab = layout.tables
    np.testing.assert_array_equal(tab[:6].view(np.float32), np.concatenate(
        [T.IMAGENET_MEAN, T.IMAGENET_STD]))
    # 640 -> 1792 and 640 -> 448, 612 -> 448, 896 -> 448 (896 -> 896 skipped)
    assert layout.launch.n_h == 4
    vjobs = tab[T.NORM + T.JOB * 4:T.NORM + T.JOB * (4 + 3 * 13)]
    live = vjobs.reshape(3, 13, T.JOB)[:, :, 7]
    np.testing.assert_array_equal(live.sum(1), [13, 1, 3])
    for n_in, n_out in ((640, 1792), (480, 1344), (896, 448), (448, 448)):
        rows = T._table(n_in, n_out)
        assert np.all(np.abs(rows[:, 1:].sum(1) - (1 << 22))
                      <= rows.shape[1])
    identity = T._table(448, 448)          # Pillow's skipped pass, exactly
    np.testing.assert_array_equal(identity[:, 1:].max(1), 1 << 22)
    np.testing.assert_array_equal(identity[:, 1:].sum(1), 1 << 22)
    assert layout.total_bytes % 16 == 0
    assert layout.offsets[0] >= 4 * tab.size and layout.offsets[0] % 16 == 0


def test_tile_images_rejects_what_it_does_not_take():
    data, launch = T.stage(images([(40, 60)]), 56, 4).packed("cpu")
    with pytest.raises(ValueError, match="uint8"):
        T.tile_images(data.view(torch.int32), launch)
    with pytest.raises(ValueError, match="uint8"):
        T.tile_images(data[:-1], launch)
    with pytest.raises(ValueError, match="no tile kernel"):
        T.tile_images(data.to("meta"), launch)
    with pytest.raises(TypeError, match="slice"):
        T.stage(images([(40, 60)]), 56, 4)[0]

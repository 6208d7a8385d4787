"""The committed fixtures of ``chip_smoke.py``'s files phase
(``tests/data/torch_port/``, written by its ``make_fixtures.py``): the
SHA-256 pinned beside each JPEG is that of this sandbox's Pillow decode,
and the port's decoder gives the same bytes; the ids pinned for the
Llama-3-layout tokenizer are ``transformers``' and the port's reader's;
the phase's PNG writer (``chip_smoke.png_file``) writes files Pillow reads
back to the same pixels; all of it stays under 1 MB.
"""

import hashlib
import io
import json
import os

import numpy as np
import pytest

import chip_smoke
from mllm_sparse_retrieval_tpu_torch.data.imageio import (
    decode_image_bytes, load_rgb)
from mllm_sparse_retrieval_tpu_torch.models.hf_tokenizer import (
    HFJsonTokenizer)

Image = pytest.importorskip("PIL.Image")
FIX = chip_smoke.FIXTURES


def _meta():
    with open(os.path.join(FIX, "images.json")) as f:
        return json.load(f)


def test_fixtures_stay_small_and_cover_the_served_sizes():
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, files in os.walk(FIX) for f in files
                if "__pycache__" not in d)
    assert total < 1_000_000
    files = _meta()["files"]
    sizes = {tuple(m["shape"][:2]) for m in files.values()}
    assert set(chip_smoke.IMAGE_SIZES) <= sizes
    modes = {(m["progressive"], m["subsampling"]) for m in files.values()}
    assert modes == {(p, s) for p in (False, True)
                     for s in ("4:2:0", "4:4:4")}


@pytest.mark.parametrize("name", sorted(_meta()["files"]))
def test_pinned_hashes_are_pillows_and_the_ports(name):
    want = _meta()["files"][name]
    path = os.path.join(FIX, "jpeg", name)
    pillow = np.asarray(Image.open(path).convert("RGB"))
    port = load_rgb(path)
    assert list(pillow.shape) == list(port.shape) == want["shape"]
    assert hashlib.sha256(pillow.tobytes()).hexdigest() == want["sha256"]
    assert hashlib.sha256(port.tobytes()).hexdigest() == want["sha256"]


def test_pinned_ids_are_transformers_and_the_readers(tmp_path):
    from transformers import AutoTokenizer

    chip_smoke.write_fixture_tokenizer(str(tmp_path))
    with open(os.path.join(FIX, "ids.json")) as f:
        pinned = json.load(f)
    hf = AutoTokenizer.from_pretrained(str(tmp_path))
    mine = HFJsonTokenizer.from_dir(str(tmp_path))
    assert len(hf) == mine.vocab_size == pinned["vocab_size"] == 128256
    assert hf.pad_token_id == mine.pad_id == pinned["pad_id"]
    assert mine.get_vocab()["<image>"] == 128255
    for text, with_sp, without in pinned["texts"]:
        assert hf.encode(text) == mine.encode(text) == with_sp
        assert hf.encode(text, add_special_tokens=False) == \
            mine.encode(text, add_special_tokens=False) == without


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("alpha", [False, True])
def test_the_phase_png_writer_round_trips(interlace, alpha):
    rng = np.random.default_rng(int(interlace) * 2 + int(alpha))
    pixels = rng.integers(0, 256, (29, 37, 3), dtype=np.uint8)
    data = chip_smoke.png_file(pixels, interlace=interlace, alpha=alpha)
    back = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(back, pixels)
    np.testing.assert_array_equal(decode_image_bytes(data), pixels)

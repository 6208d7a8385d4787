"""PyTorch port: image file decoding (``data/imageio.py`` and its C++
source ``data/native/imagecodec.cc``) against this sandbox's Pillow 12.1.0
(libjpeg-turbo 3.1.3).

Images are seeded smooth content (gradients, discs, mild noise) written by
Pillow here, except the Adam7 PNGs, which this file writes itself with
``zlib`` (Pillow cannot write interlace), and the 4:1:1 / 4:4:0 JPEGs,
which OpenCV writes where it is installed. Exact: every decoded array
equals ``np.asarray(Image.open(f).convert("RGB"))`` bit for bit; the
port's default loaders equal the JAX package's (Pillow's decode and
bicubic resize) bit for bit in float32; ``router.decode_image`` equals the
JAX router's on a valid JPEG, and ``POST /search`` gives the JAX router's
status on a valid JPEG (accepted), invalid base64, non-image bytes and a
truncated JPEG (400). Refused input (GIF / WebP / BMP / TIFF, arithmetic
or 12-bit JPEG, truncated or corrupt files, a progressive JPEG that is
not fully refined) raises ``ValueError`` naming the file and the feature;
a failed ``g++`` build raises. Bounded memory: a frame header past
Pillow's bomb limit is refused from the header, a JPEG header with no scan
allocates nothing, and a PNG deflate bomb is inflated only as far as the
image's rows, each in a child process whose peak resident size must stay
within 64 MiB of where it started.
"""

import base64
import io
import json
import struct
import zlib

import numpy as np
import pytest

from mllm_sparse_retrieval_tpu.data.karpathy import Example as JExample
from mllm_sparse_retrieval_tpu.pipelines import encode as jencode
from mllm_sparse_retrieval_tpu.serving import router as jrouter
from mllm_sparse_retrieval_tpu_torch.data import imageio
from mllm_sparse_retrieval_tpu_torch.data.imageio import (
    decode_image_bytes, load_rgb)
from mllm_sparse_retrieval_tpu_torch.data.karpathy import Example
from mllm_sparse_retrieval_tpu_torch.pipelines import encode as pencode
from mllm_sparse_retrieval_tpu_torch.serving import router

Image = pytest.importorskip("PIL.Image")

SIZES = [(1, 1), (17, 33), (479, 641)]


def smooth_image(seed, h, w):
    """Seeded uint8 [h, w, 3]: gradients, six flat discs and mild noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([x / w * 255, y / h * 255, (x + y) / (h + w) * 255], -1)
    for _ in range(6):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(3, max(h, w) / 3 + 4)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg_bytes(img, mode="RGB", **kw):
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def pillow_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_decodes_as_pillow(data):
    got = decode_image_bytes(data)
    want = pillow_rgb(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_baseline_jpeg_equals_pillow(size, quality):
    img = smooth_image(quality + size[0], *size)
    for subsampling in (0, 1, 2):        # 4:4:4, 4:2:2, 4:2:0
        assert_decodes_as_pillow(jpeg_bytes(img, quality=quality,
                                            subsampling=subsampling))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("options", [
    dict(progressive=True), dict(optimize=True),
    dict(progressive=True, optimize=True, subsampling=0),
    dict(restart_marker_blocks=1), dict(restart_marker_rows=2),
    dict(progressive=True, restart_marker_blocks=5),
    dict(keep_rgb=True), dict(quality=100), dict(quality=1)],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_jpeg_options_equal_pillow(size, options):
    img = smooth_image(7 + size[1], *size)
    data = jpeg_bytes(img, **options)
    if "restart_marker_blocks" in options or "restart_marker_rows" in \
            options:
        assert b"\xff\xdd" in data
    assert_decodes_as_pillow(data)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["L", "CMYK", "YCCK"])
@pytest.mark.parametrize("progressive", [False, True])
def test_gray_cmyk_and_ycck_jpeg_equal_pillow(size, mode, progressive):
    img = smooth_image(3 + size[0], *size)
    data = jpeg_bytes(img, "CMYK" if mode == "YCCK" else mode, quality=80,
                      progressive=progressive)
    if mode == "YCCK":
        # the same scans read as YCCK: Adobe APP14 transform 0 -> 2
        data = bytearray(data)
        at = data.index(b"Adobe")
        assert data[at + 11] == 0
        data[at + 11] = 2
        data = bytes(data)
    assert_decodes_as_pillow(data)


@pytest.mark.parametrize("factor", ["411", "440", "422", "420", "444"])
def test_other_sampling_factors_equal_pillow(factor):
    cv2 = pytest.importorskip("cv2")
    img = smooth_image(11, 123, 219)
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}"),
        cv2.IMWRITE_JPEG_QUALITY, 85])
    assert ok
    assert_decodes_as_pillow(buf.tobytes())


def png_bytes(img, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode, **kw).save(buf, "PNG")
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "1"])
def test_png_modes_equal_pillow(mode):
    img = smooth_image(5, 37, 53)
    assert_decodes_as_pillow(png_bytes(img, mode))
    for bits in (1, 2, 4):          # low-depth palettes
        buf = io.BytesIO()
        Image.fromarray(img).convert(
            "P", palette=Image.ADAPTIVE, colors=2 ** bits).save(
                buf, "PNG", bits=bits)
        assert_decodes_as_pillow(buf.getvalue())


def test_16_bit_gray_png_equals_pillow():
    rng = np.random.default_rng(2)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 700, (19, 23)).astype(np.uint16)).save(
        buf, "PNG")
    assert_decodes_as_pillow(buf.getvalue())


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _pack_row(samples, depth):
    if depth >= 8:
        return samples.astype(">u2" if depth == 16 else np.uint8).tobytes()
    per = 8 // depth
    out = bytearray(-(-len(samples) // per))
    for i, v in enumerate(samples):
        out[i // per] |= int(v) << (8 - depth * (i % per + 1))
    return bytes(out)


def _filter_rows(rows, bpp):
    """Each row filtered with type (row index mod 5): all five filters."""
    out, prev = bytearray(), bytes(len(rows[0]))
    for r, row in enumerate(rows):
        ft = r % 5
        out.append(ft)
        for i in range(len(row)):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if ft == 1:
                pred = a
            elif ft == 2:
                pred = b
            elif ft == 3:
                pred = (a + b) // 2
            elif ft == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                pred = 0
            out.append((row[i] - pred) & 255)
        prev = row
    return bytes(out)


def write_png(arr, depth, ctype, interlace, palette=None):
    """A PNG of ``arr`` [H, W, C] at ``depth``, Adam7 when ``interlace``."""
    h, w, chans = arr.shape
    bpp = max(1, depth * chans // 8)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                               (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                               (0, 1, 1, 2)):
            sub = arr[y0::dy, x0::dx]
            if sub.shape[0] and sub.shape[1]:
                raw += _filter_rows([_pack_row(r.reshape(-1), depth)
                                     for r in sub], bpp)
    else:
        raw = _filter_rows([_pack_row(r.reshape(-1), depth) for r in arr],
                           bpp)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


@pytest.mark.parametrize("ctype,depth", [
    (0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 2),
    (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)])
def test_written_png_adam7_and_plain_equal_pillow(ctype, depth):
    rng = np.random.default_rng(ctype * 100 + depth)
    chans = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    palette = rng.integers(0, 256, 15).astype(np.uint8).tobytes() \
        if ctype == 3 else None
    top = min(2 ** depth, 5) if ctype == 3 else 2 ** depth
    for h, w in ((1, 1), (5, 3), (13, 29)):
        arr = rng.integers(0, top, (h, w, chans))
        for interlace in (0, 1):
            assert_decodes_as_pillow(write_png(arr, depth, ctype, interlace,
                                               palette))


def _drop_refinement_scans(data):
    """A progressive JPEG without its successive-approximation refinement
    scans (Ah > 0): coefficients left unrefined."""
    out, pos = bytearray(data[:2]), 2
    while pos < len(data):
        assert data[pos] == 0xFF
        marker = data[pos + 1]
        if marker == 0xD9:
            out += data[pos:pos + 2]
            break
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        end = pos + 2 + length
        if marker == 0xDA:          # entropy data runs to the next marker
            while not (data[end] == 0xFF and data[end + 1] not in
                       (0x00, *range(0xD0, 0xD8))):
                end += 1
            ns = data[pos + 4]
            ah = data[pos + 5 + 2 * ns + 2] >> 4
            if ah:
                pos = end
                continue
        out += data[pos:end]
        pos = end
    return bytes(out)


def test_refused_input_raises_naming_the_file_and_feature(tmp_path):
    img = smooth_image(1, 40, 56)
    jpeg = jpeg_bytes(img, quality=80)
    cases = {}
    for fmt, name in (("GIF", "GIF"), ("WEBP", "WebP"), ("BMP", "BMP"),
                      ("TIFF", "TIFF")):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, fmt)
        cases[name] = (buf.getvalue(), f"{name} files are not decoded")
    sof = jpeg.index(b"\xff\xc0")
    cases["arith"] = (jpeg[:sof + 1] + b"\xc9" + jpeg[sof + 2:],
                      "arithmetic-coded JPEG")
    cases["12bit"] = (jpeg[:sof + 4] + b"\x0c" + jpeg[sof + 5:],
                      "12-bit JPEG")
    cases["truncated"] = (jpeg[:len(jpeg) // 2], "truncated")
    cases["no_eoi"] = (jpeg[:-2], "truncated")
    cases["corrupt"] = (jpeg[:sof + 2] + b"\x00\x01" + jpeg[sof + 4:],
                        "JPEG")
    prog = jpeg_bytes(img, quality=80, progressive=True)
    cases["unrefined"] = (_drop_refinement_scans(prog), "not fully refined")
    png = png_bytes(img, "RGB")
    cases["png_truncated"] = (png[:len(png) // 2], "truncated PNG")
    bad = bytearray(png)
    bad[30] ^= 0xFF                # inside IHDR's checksum
    cases["png_crc"] = (bytes(bad), "bad checksum")
    cases["text"] = (b"hello, not an image", "not a JPEG or PNG")
    cases["empty"] = (b"", "not a JPEG or PNG")
    for label, (data, feature) in cases.items():
        path = tmp_path / f"{label}.bin"
        path.write_bytes(data)
        with pytest.raises(ValueError) as e:
            load_rgb(path)
        assert str(path) in str(e.value) and feature in str(e.value), \
            (label, str(e.value))
    # Pillow refuses the truncated and corrupt files too (never padded)
    for label in ("truncated", "no_eoi", "png_truncated", "text"):
        with pytest.raises(OSError):
            pillow_rgb(cases[label][0])
    # Pillow smooths the unrefined blocks; the port refuses them
    assert pillow_rgb(cases["unrefined"][0]).shape == (40, 56, 3)


def _resized_header(data, width, height):
    """A JPEG whose frame header declares ``width`` x ``height``."""
    at = data.index(b"\xff\xc0") + 5
    return data[:at] + struct.pack(">HH", height, width) + data[at + 4:]


def _sof_only_jpeg(width, height, ncomp):
    """SOI, a baseline frame header and EOI: ~30 bytes that declare a
    ``width`` x ``height`` image of ``ncomp`` components."""
    comps = b"".join(bytes([i + 1, 0x11, 0]) for i in range(ncomp))
    sof = struct.pack(">HBHHB", 8 + 3 * ncomp, 8, height, width, ncomp)
    return b"\xff\xd8\xff\xc0" + sof + comps + b"\xff\xd9"


# Runs in a child process: the codec is built first, then the address space
# is capped 2 GiB above what the child holds (a regression fails there with
# bad_alloc / MemoryError instead of taking the machine's memory), and the
# peak resident size must stay within 64 MiB of where it was.
_BOUNDED_CHILD = r"""
import json, resource, struct, sys, zlib
import numpy as np
from mllm_sparse_retrieval_tpu_torch.data import imageio


def chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


imageio.load()
cases = json.loads(sys.argv[1])
bombs = {}
for label, spec in cases.items():
    if spec[0] == "png_bomb":       # 64 x 64 RGB rows, then zeros
        _, extra = spec
        rows = b"".join(b"\0" + bytes((y + x) % 256 for x in range(192))
                        for y in range(64))
        z = zlib.compressobj(1)
        parts = [z.compress(rows)]
        parts += [z.compress(bytes(1 << 24)) for _ in range(extra >> 24)]
        bombs[label] = b"".join(parts + [z.flush()])
vm = [int(l.split()[1]) for l in open("/proc/self/status")
      if l.startswith("VmSize:")][0] * 1024
resource.setrlimit(resource.RLIMIT_AS, (vm + (2 << 30), vm + (2 << 30)))
base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
out = {}
for label, spec in cases.items():
    if spec[0] == "png_bomb":
        data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 64, 64, 8, 2, 0, 0, 0)) + chunk(b"IDAT", bombs[label])
            + chunk(b"IEND", b""))
    else:
        data = bytes.fromhex(spec[1])
    try:
        arr = imageio.decode_image_bytes(data, label)
        out[label] = ["ok", list(arr.shape), int(arr.astype(np.int64).sum())]
    except Exception as e:
        out[label] = [type(e).__name__, str(e)]
out["grew_kib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - base
print(json.dumps(out))
"""


def _run_bounded(cases):
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    imageio.load()        # build once here; the child finds the library
    proc = subprocess.run(
        [sys.executable, "-c", _BOUNDED_CHILD, json.dumps(cases)],
        cwd=root, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": root})
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out.pop("grew_kib") < 64 * 1024, out
    return out


def test_oversized_or_empty_frames_are_refused_before_allocating():
    """A tiny frame header past Pillow's bomb limit (65,535² pixels, 3 or 4
    components: 26-34 GB of coefficients) is refused from the header alone,
    as Pillow refuses it before it allocates; one under the limit with no
    scan allocates nothing either. The PNG header is checked the same way."""
    limit = f"exceed the limit of {imageio.MAX_PIXELS}"
    png_header = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 65535, 65535, 8, 6, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(b"\0" * 1024))
        + _chunk(b"IEND", b""))
    img = smooth_image(2, 24, 40)
    cases = {"jpeg3": ["bytes", _resized_header(
                 jpeg_bytes(img, quality=80), 65535, 65535).hex()],
             "jpeg4": ["bytes", _resized_header(
                 jpeg_bytes(img, "CMYK", quality=80), 65535, 65535).hex()],
             "png": ["bytes", png_header.hex()],
             "jpeg_no_scan": ["bytes", _sof_only_jpeg(13000, 13000, 3).hex()]}
    out = _run_bounded(cases)
    for label in ("jpeg3", "jpeg4", "png"):
        assert out[label][0] == "ValueError", out[label]
        assert out[label][1].startswith(label + ": "), out[label]
        assert "65535 x 65535 pixels " + limit in out[label][1], out[label]
    assert out["jpeg_no_scan"][0] == "ValueError", out
    assert "JPEG without image data" in out["jpeg_no_scan"][1], out
    for label in ("jpeg3", "jpeg4", "png"):
        with pytest.raises(Image.DecompressionBombError):
            Image.open(io.BytesIO(bytes.fromhex(cases[label][1]))).load()


def test_png_deflate_bomb_inflates_only_the_image():
    """An IDAT stream that inflates to 512 MiB past a 64 x 64 image's rows
    is read only as far as the image: the pixels come out (Pillow ignores
    the rest too) and the process grows by no more than 64 MiB."""
    out = _run_bounded({"bomb": ["png_bomb", 512 << 20]})
    want = sum(((y + x) % 256) for y in range(64) for x in range(192))
    assert out["bomb"] == ["ok", [64, 64, 3], want], out


@pytest.mark.parametrize("tail", ["trailing_data", "no_stream_end",
                                  "cut_in_the_rows"])
def test_png_stream_ends_as_pillow(tail):
    """Data past the image rows is ignored and a missing zlib end (the
    Adler-32) is accepted, as Pillow does; a stream cut inside the rows is
    truncated for both."""
    img = smooth_image(5, 21, 34)
    raw = b"".join(b"\0" + row.tobytes() for row in img)
    idat = {"trailing_data": zlib.compress(raw + bytes(999)),
            "no_stream_end": zlib.compress(raw)[:-4],
            "cut_in_the_rows": zlib.compress(raw)[:-40]}[tail]
    data = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 34, 21, 8, 2, 0, 0, 0)) + _chunk(b"IDAT", idat)
        + _chunk(b"IEND", b""))
    if tail == "cut_in_the_rows":
        with pytest.raises(ValueError, match="truncated PNG image data"):
            decode_image_bytes(data)
        with pytest.raises(OSError):
            pillow_rgb(data)
    else:
        assert_decodes_as_pillow(data)
        np.testing.assert_array_equal(decode_image_bytes(data), img)


def test_a_failed_build_raises(monkeypatch):
    monkeypatch.setenv("CXX", "/nonexistent/compiler/g++")
    with pytest.raises(RuntimeError, match="cannot build the image codec"):
        imageio.load()


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def test_loaders_equal_the_jax_loaders(tmp_path):
    files = [
        _write(tmp_path, "a.jpg", jpeg_bytes(smooth_image(0, 333, 500),
                                             quality=85)),
        _write(tmp_path, "b.jpg", jpeg_bytes(smooth_image(1, 480, 211),
                                             quality=70, progressive=True)),
        _write(tmp_path, "c.png", png_bytes(smooth_image(2, 64, 97),
                                            "RGBA")),
        _write(tmp_path, "d.jpg", jpeg_bytes(smooth_image(3, 50, 50), "L")),
        str(tmp_path / "absent.jpg")]
    for i, path in enumerate(files):
        ex = Example(f"t{i}", path, "a cap", f"i{i}")
        jex = JExample(f"t{i}", path, "a cap", f"i{i}")
        for size in (336, 28):
            got = pencode.default_pixel_loader(size)(ex)
            want = jencode.default_pixel_loader(size)(jex)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        got = pencode.default_raw_image_loader()(ex)
        want = jencode.default_raw_image_loader()(jex)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


class _Svc:
    """The bits of a service ``POST /search`` touches before the engine."""
    impact_index = None

    def search_async(self, **kwargs):
        return kwargs


def test_decode_image_and_search_statuses_equal_the_jax_router():
    jpeg = jpeg_bytes(smooth_image(4, 61, 47), quality=90)
    b64 = base64.b64encode(jpeg).decode()
    np.testing.assert_array_equal(router.decode_image(b64),
                                  jrouter.decode_image(b64))
    payloads = {
        "valid": b64,
        "invalid_base64": "abc",
        "not_an_image": base64.b64encode(b"hello").decode(),
        "truncated": base64.b64encode(jpeg[:len(jpeg) // 2]).decode()}
    for label, payload in payloads.items():
        body = json.dumps({"queries": [{"image_b64": payload}]}).encode()
        got = router.route(_Svc(), "POST", "/search", body)
        want = jrouter.route(_Svc(), "POST", "/search", body)
        if label == "valid":
            assert isinstance(got, router.PendingSearch)
            assert isinstance(want, jrouter.PendingSearch)
            np.testing.assert_array_equal(got.futures[0]["image"],
                                          want.futures[0]["image"])
        else:
            assert (got.status, want.status) == (400, 400), label


"""PyTorch port, the slice as a whole: a converted LLaVA-NeXT checkpoint
with its ``tokenizer.json`` and a Karpathy-layout corpus of JPEG and PNG
files, through the port's ``cli.encode`` -> ``cli.index`` -> ``cli.search``
with no ``transformers`` or Pillow in the path (the tokenizer is read by
``models/hf_tokenizer.py``, the images by ``data/imageio.py``), against the
JAX package's CLIs (``AutoTokenizer`` and Pillow) on the same directory.

The checkpoint is a tiny random-init ``LlavaNextForConditionalGeneration``
(ViT 28 px / 14, three pinpoints, a 2-layer decoder at the tokenizer's
vocabulary, ``<image>`` at the tokenizer's id) saved by ``transformers``
with the Llama-3-style tokenizer of ``test_torch_hf_tokenizer.py`` beside
it and converted by the port's ``convert_hf_dir``; the JAX CLIs run with
their compile cache off. Exact: the sparse jsonl, the saved index
(``terms.json`` and every array of ``index.npz``), the ids of the dense
pickles, each query's docs and integer scores in the sparse TREC run and
the printed dense recall / MRR lines, and each query's doc set in the
fused run; the dense vectors and dense run scores agree to f32 ``1e-5``
(the offline tests' tolerance; min-max fusion over six docs magnifies that
noise, so fused scores are not compared). The sparse and fused recall
lines are not compared: docs tied on an integer score may come in either
order at a cutoff (ROADMAP's tie rule).
"""

import io
import json
import pickle

import numpy as np
import pytest

from mllm_sparse_retrieval_tpu.cli import common as jcommon
from mllm_sparse_retrieval_tpu.cli import encode as jcli_encode
from mllm_sparse_retrieval_tpu.cli import index as jcli_index
from mllm_sparse_retrieval_tpu.cli import search as jcli_search
from mllm_sparse_retrieval_tpu_torch.cli import encode as cli_encode
from mllm_sparse_retrieval_tpu_torch.cli import index as cli_index
from mllm_sparse_retrieval_tpu_torch.cli import search as cli_search
from mllm_sparse_retrieval_tpu_torch.models import convert
from mllm_sparse_retrieval_tpu_torch.models.hf_tokenizer import (
    HFJsonTokenizer)
from tests.test_torch_hf_tokenizer import build_tokenizer
from tests.test_torch_imageio import jpeg_bytes, png_bytes, smooth_image

transformers = pytest.importorskip("transformers")
Image = pytest.importorskip("PIL.Image")

WORDS = ["dog", "cat", "red", "bus", "man", "kite", "boat", "lake", "snow",
         "child", "bird", "grass", "tree", "ball", "people", "water"]
# (file name, size, writer): anyres sizes over the three pinpoints
IMAGES = [("0.jpg", (40, 90), dict(quality=90)),
          ("1.jpg", (90, 40), dict(quality=75, progressive=True)),
          ("2.png", (56, 56), "RGB"),
          ("3.jpg", (33, 47), dict(quality=60, subsampling=0)),
          ("4.png", (70, 35), "RGBA"),
          ("5.jpg", (64, 64), dict(quality=85, optimize=True,
                                   restart_marker_blocks=2))]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """(data_root, converted checkpoint directory)."""
    import torch

    root = tmp_path_factory.mktemp("real_files")
    tok_dir = build_tokenizer("llama3", root / "tok", seed=3)
    tok = HFJsonTokenizer.from_dir(str(tok_dir))
    cfg = transformers.LlavaNextConfig(
        vision_config=transformers.CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, image_size=28, patch_size=14,
            projection_dim=32),
        text_config=transformers.LlamaConfig(
            vocab_size=tok.vocab_size, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, rope_theta=10000.0, rms_norm_eps=1e-5),
        image_token_index=tok.get_vocab()["<image>"],
        vision_feature_layer=-2, projector_hidden_act="gelu",
        image_grid_pinpoints=[[28, 56], [56, 28], [56, 56]])
    torch.manual_seed(7)
    hf = root / "hf"
    transformers.LlavaNextForConditionalGeneration(cfg).eval() \
        .save_pretrained(str(hf))
    for name in ("tokenizer.json", "tokenizer_config.json",
                 "special_tokens_map.json"):
        (hf / name).write_bytes((tok_dir / name).read_bytes())
    ckpt = root / "ckpt"
    convert.convert_hf_dir(str(hf), str(ckpt))

    data = root / "data"
    images = data / "flickr" / "flickr30k-images"
    images.mkdir(parents=True)
    rng = np.random.default_rng(12)
    lines = ["imgid,filename,caption,sentid"]
    for i, (name, size, how) in enumerate(IMAGES):
        img = smooth_image(20 + i, *size)
        data_bytes = png_bytes(img, how) if name.endswith(".png") \
            else jpeg_bytes(img, **how)
        (images / name).write_bytes(data_bytes)
        for c in range(2):
            cap = "a " + " ".join(rng.choice(WORDS, int(rng.integers(3, 7))))
            lines.append(f"{i},{name},{cap},{10 + 2 * i + c}")
    (data / "flickr" / "flickr_test.csv").write_text("\n".join(lines) + "\n")
    return data, ckpt


def _args(data, ckpt):
    return ["--dataset", "flickr", "--data-root", str(data), "--family",
            "llava_next_llama3", "--checkpoint-path", str(ckpt), "--dtype",
            "float32", "--batch-size", "4"]


def _leaf(base, kind):
    # a checkpoint's artifacts are named by its directory
    return base / "ckpt" / "flickr" / kind / "filter" / "0_no_manual_128"


def _run_clis(pkg, data, ckpt, out, query_type, doc_type, capsys):
    encode, index, search = pkg
    device = ["--device", "cpu"] if encode is cli_encode else []
    encode.main(_args(data, ckpt) + device + [
        "--encode-type", doc_type, "--dense-output-dir", str(out / "dense"),
        "--sparse-output-dir", str(out / "sparse")])
    capsys.readouterr()
    index.main(["--input", str(_leaf(out / "sparse", doc_type)), "--index",
                str(out / "idx")] + device)
    capsys.readouterr()
    search.main(_args(data, ckpt) + device + [
        "--query-type", query_type, "--passage-reps",
        str(_leaf(out / "dense", doc_type)), "--sparse-index",
        str(out / "idx"), "--depth", "20", "--metrics", "mrr",
        "--save-dir", str(out / "runs")])
    return capsys.readouterr().out.strip()


@pytest.mark.parametrize("query_type,doc_type", [("text", "image"),
                                                 ("image", "text")])
def test_cli_pipeline_on_files_and_tokenizer_json_matches_jax_clis(
        workspace, tmp_path, capsys, monkeypatch, query_type, doc_type):
    data, ckpt = workspace
    monkeypatch.setattr(jcommon, "enable_compilation_cache",
                        lambda *a, **k: None)
    got = _run_clis((cli_encode, cli_index, cli_search), data, ckpt,
                    tmp_path / "port", query_type, doc_type, capsys)
    want = _run_clis((jcli_encode, jcli_index, jcli_search), data, ckpt,
                     tmp_path / "jax", query_type, doc_type, capsys)
    # dense recall has no ties; the sparse and fused runs may order docs
    # tied on an integer score either way, so they are compared as scores
    dense_lines = [ln for ln in got.splitlines() if ln.startswith("dense")]
    assert dense_lines == [ln for ln in want.splitlines()
                           if ln.startswith("dense")] and dense_lines
    assert len(got.splitlines()) == len(want.splitlines()) == 6

    port, jax_ = tmp_path / "port", tmp_path / "jax"
    for leaf in (lambda b: _leaf(b / "sparse", doc_type),):
        assert (leaf(port) / "corpus_0.jsonl").read_text() == \
            (leaf(jax_) / "corpus_0.jsonl").read_text()
    with open(_leaf(port / "dense", doc_type) / "corpus_0.pkl", "rb") as f:
        dense, ids = pickle.load(f)
    with open(_leaf(jax_ / "dense", doc_type) / "corpus_0.pkl", "rb") as f:
        jdense, jids = pickle.load(f)
    assert ids == jids and len(ids) == (6 if doc_type == "image" else 12)
    np.testing.assert_allclose(dense, np.asarray(jdense), atol=1e-5,
                               rtol=1e-5)
    assert json.loads((port / "idx" / "terms.json").read_text()) == \
        json.loads((jax_ / "idx" / "terms.json").read_text())
    with np.load(port / "idx" / "index.npz") as a, \
            np.load(jax_ / "idx" / "index.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    for name in ("dense", "sparse", "fusion"):
        runs = []
        for base in (port, jax_):
            per_q = {}
            for line in (base / "runs" / f"{name}.trec").read_text() \
                    .splitlines():
                q, _, d, _, score, _ = line.split()
                per_q.setdefault(q, {})[d] = float(score)
            runs.append(per_q)
        assert runs[0].keys() == runs[1].keys() and runs[0]
        for q, scores in runs[0].items():
            assert scores.keys() == runs[1][q].keys()
            for d, score in scores.items():
                if name == "sparse":      # integer impacts: exact
                    assert score == runs[1][q][d]
                elif name == "dense":
                    assert abs(score - runs[1][q][d]) <= 1e-5 * (
                        1 + abs(score))


def test_the_files_are_what_the_port_decodes(workspace):
    """The corpus really holds encoded JPEG and PNG files, which the port's
    loader decodes as Pillow does."""
    from mllm_sparse_retrieval_tpu_torch.data.imageio import load_rgb

    data, _ = workspace
    images = data / "flickr" / "flickr30k-images"
    for name, size, _ in IMAGES:
        raw = (images / name).read_bytes()
        assert raw[:2] in (b"\xff\xd8", b"\x89P")
        want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
        got = load_rgb(images / name)
        assert got.shape == size + (3,)
        np.testing.assert_array_equal(got, want)

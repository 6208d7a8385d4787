"""PyTorch port, ``eval/statistics.py`` and ``cli.stats`` against the JAX
package on a flickr CSV this file writes: ``term_weight_statistics`` on
``tiny_debug`` (with adapters) and ``tiny_qwen_debug`` (M-RoPE ids) on the
JAX weights (``from_jax_params``), and ``fusion_provenance_statistics`` on
seeded runs. The JAX function cannot encode the images of the variable
families (their specs have no ``preprocess``; it raises ``TypeError``); the
port's encodes them through the training collator, held here to the JAX
package's ``encode_any`` on the JAX collator's batches (tiny InternVL2.5
and Qwen2.5-VL at native resolution). Then ``cli.stats --device cpu`` in
both modes.

Tolerances: sparse weights and the statistics' arrays f32
``atol=rtol=1e-5`` (XLA and PyTorch sum in other orders); provenance ranks
and printed summaries exact.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mllm_sparse_retrieval_tpu.configs import ModelConfig as JModelConfig
from mllm_sparse_retrieval_tpu.configs import ModelFamily as JFamily
from mllm_sparse_retrieval_tpu.configs import RepsLoc as JRepsLoc
from mllm_sparse_retrieval_tpu.configs import SparseConfig as JSparseConfig
from mllm_sparse_retrieval_tpu.data.karpathy import CrossModalCorpus as JCorpus
from mllm_sparse_retrieval_tpu.eval import statistics as jstats
from mllm_sparse_retrieval_tpu.models import api as japi
from mllm_sparse_retrieval_tpu.models import build_model as j_build_model
from mllm_sparse_retrieval_tpu.models import internvl as jinternvl
from mllm_sparse_retrieval_tpu.models import lora as jlora
from mllm_sparse_retrieval_tpu.models import qwen_vl as jqwen
from mllm_sparse_retrieval_tpu.models import templates as jtemplates
from mllm_sparse_retrieval_tpu.train import trainer as jtrainer
from mllm_sparse_retrieval_tpu_torch.cli import encode as cli_encode
from mllm_sparse_retrieval_tpu_torch.cli import index as cli_index
from mllm_sparse_retrieval_tpu_torch.cli import stats as cli_stats
from mllm_sparse_retrieval_tpu_torch.configs import (
    ModelConfig, ModelFamily, SearchConfig, SparseConfig)
from mllm_sparse_retrieval_tpu_torch.data.karpathy import CrossModalCorpus
from mllm_sparse_retrieval_tpu_torch.eval import statistics
from mllm_sparse_retrieval_tpu_torch.index.dense import DenseFlatIndex
from mllm_sparse_retrieval_tpu_torch.index.impact import ImpactIndex
from mllm_sparse_retrieval_tpu_torch.models import build_model, templates
from mllm_sparse_retrieval_tpu_torch.models.convert_jax import (
    from_jax_lora, from_jax_params)
from mllm_sparse_retrieval_tpu_torch.search.engine import run_search
from tests.test_torch_chat_templates import (
    chat_tokenizers, images, noisy, port_arch)
from tests.test_torch_internvl import _jarch as _internvl_jarch
from tests.test_torch_qwen_vl import _jarch as _qwen_jarch
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
WORDS = ["dog", "cat", "red", "bus", "man", "kite", "boat", "lake", "snow",
         "child", "bird", "wire", "grass", "city", "tree", "ball"]
FIELDS = ("image_in_text", "image_out_text", "text_in_text", "text_out_text")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("stats")
    rng = np.random.default_rng(8)
    (root / "flickr").mkdir()
    lines = ["imgid,filename,caption,sentid"]
    for i in range(6):
        for c in range(2):
            cap = "a " + " ".join(rng.choice(WORDS, size=int(
                rng.integers(3, 7))))
            lines.append(f"{70 + i},{70 + i}.jpg,{cap},{200 + 2 * i + c}")
    (root / "flickr" / "flickr_test.csv").write_text("\n".join(lines) + "\n")
    return root


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("family", ["TINY_DEBUG", "TINY_QWEN_DEBUG"])
def test_term_weight_statistics_matches_jax(data_root, family):
    jcorpus = JCorpus("flickr", "test", str(data_root))
    captions = list(jcorpus.text_dict.values())
    jparams, jarch, jtok, jtmpl = j_build_model(
        JModelConfig(family=JFamily[family], dtype="float32"),
        captions=captions)
    _, arch, tok, tmpl = build_model(
        ModelConfig(family=ModelFamily[family], dtype="float32"),
        captions=captions, device="cpu")
    assert tok.get_vocab() == jtok.get_vocab()
    jad = ad = None
    if family == "TINY_DEBUG":          # adapters that change the weights
        jad = _np(jlora.init_lora(jax.random.PRNGKey(4), jparams, jarch,
                                  rank=4, alpha=8.0))
        rng = np.random.default_rng(4)
        for blk in jad["text"]["blocks"]:
            blk["q"]["b"] = (0.2 * rng.normal(size=blk["q"]["b"].shape)
                             ).astype(np.float32)
        ad = from_jax_lora(jad, "cpu")
        jad = jax.tree_util.tree_map(jnp.asarray, jad)
    want = jstats.term_weight_statistics(
        jcorpus, jparams, jarch, jtok, jtmpl, sparse_cfg=JSparseConfig(),
        num_images=5, batch_size=4, lora=jad)
    got = statistics.term_weight_statistics(
        CrossModalCorpus("flickr", "test", str(data_root)),
        from_jax_params(_np(jparams), "cpu"), arch, tok, tmpl,
        sparse_cfg=SparseConfig(), num_images=5, batch_size=4, lora=ad,
        device="cpu")
    for f in FIELDS:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.shape == w.shape and g.size > 0, f
        np.testing.assert_allclose(g, w, **TOL)
    assert got.summary() == want.summary()


@pytest.mark.parametrize("family", ["internvl", "qwen_native"])
def test_variable_family_images_match_jax_encode_any(data_root, family):
    jtok, tok = chat_tokenizers()
    if family == "internvl":
        jarch = _internvl_jarch(
            image_token_id=jtok.special_ids["<IMG_CONTEXT>"])
        jparams = noisy(jinternvl.init_params(jax.random.PRNGKey(31),
                                              jarch), 32)
        name = "INTERNVL2_5"
    else:
        jarch = _qwen_jarch(image_token_id=jtok.special_ids["<|image_pad|>"],
                            max_units=16)
        jparams = noisy(jqwen.init_params(jax.random.PRNGKey(33), jarch), 34)
        name = "QWEN2_5_VL"
    jtmpl, tmpl = getattr(jtemplates, name), getattr(templates, name)
    arch, params = port_arch(jarch), from_jax_params(jparams, "cpu")
    corpus = CrossModalCorpus("flickr", "test", str(data_root))
    jcorpus = JCorpus("flickr", "test", str(data_root))
    with pytest.raises(TypeError):
        jstats.term_weight_statistics(
            jcorpus, jparams, jarch, jtok, jtmpl, sparse_cfg=JSparseConfig(),
            num_images=2, batch_size=2)
    raw = dict(zip([e.img_id for e in corpus.examples_single()],
                   images(6, [(64, 64), (40, 120), (120, 40), (30, 30),
                              (90, 60), (61, 200)])))

    def load(e):
        return raw[e.img_id]

    got = statistics._raw_sparse(corpus.examples_single()[:5], params, arch,
                                 tok, tmpl, "image", 4, None, load, "cpu")
    jcol = jtrainer.make_collator(jtok, jtmpl, jarch, pixel_loader=load)
    jex = jcorpus.examples_single()
    want = []
    for lo in (0, 4):
        batch = jex[lo:lo + 4]
        batch = batch + [batch[-1]] * (4 - len(batch))
        jb = jcol(batch)
        s, _ = japi.encode_any(
            jparams, jarch, jnp.asarray(jb.image_ids),
            jnp.asarray(jb.image_mask), jax.tree_util.tree_map(
                jnp.asarray, jb.pixels), JRepsLoc.BEFORE_PAD, None,
            position_ids=None if jb.image_pos_ids is None
            else jnp.asarray(jb.image_pos_ids))
        want.append(np.asarray(s)[:5 - lo])
    want = np.concatenate(want)
    assert got.shape == want.shape == (5, jarch.text.vocab_size)
    np.testing.assert_allclose(got, want, **TOL)
    stats = statistics.term_weight_statistics(
        corpus, params, arch, tok, tmpl, sparse_cfg=SparseConfig(),
        num_images=3, batch_size=2, pixel_loader=load, device="cpu")
    assert stats.image_in_text.size + stats.image_out_text.size == \
        3 * tok.vocab_size
    assert all(np.isfinite(getattr(stats, f)).all() for f in FIELDS)


def _rand_run(rng, n_q, depth=30):
    run = {}
    for q in range(n_q):
        docs = {f"d{d}": rng.uniform(-1, 5)
                for d in rng.sample(range(60), depth)}
        run[f"q{q}"] = {"docs": docs, "min_score": min(docs.values()),
                        "max_score": max(docs.values())}
    return run


def test_fusion_provenance_statistics_matches_jax():
    rng = random.Random(9)
    dense, sparse = _rand_run(rng, 12), _rand_run(rng, 12)
    for alpha, top_n in ((0.5, 200), (0.3, 10)):
        got = statistics.fusion_provenance_statistics(dense, sparse, alpha,
                                                      top_n)
        want = jstats.fusion_provenance_statistics(dense, sparse, alpha,
                                                   top_n)
        for f in ("dense_ranks", "sparse_ranks", "fused_ranks"):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(want, f))
        assert got.summary() == want.summary()
        if top_n == 200:              # every doc of every query ranked
            assert got.dense_ranks.size and got.sparse_ranks.size and \
                got.fused_ranks.size


def _common(data_root):
    return ["--dataset", "flickr", "--data-root", str(data_root),
            "--family", "tiny_debug", "--dtype", "float32", "--device",
            "cpu", "--batch-size", "4"]


def test_stats_cli_both_modes(data_root, tmp_path, capsys):
    out = tmp_path / "stats"
    cli_stats.main(_common(data_root) + ["--num-images", "4", "--out-dir",
                                         str(out)])
    printed = capsys.readouterr().out.splitlines()
    corpus = CrossModalCorpus("flickr", "test", str(data_root))
    params, arch, tok, tmpl = build_model(
        ModelConfig(family=ModelFamily.TINY_DEBUG, dtype="float32"),
        captions=list(corpus.text_dict.values()), device="cpu")
    want = statistics.term_weight_statistics(
        corpus, params, arch, tok, tmpl, sparse_cfg=SparseConfig(),
        num_images=4, batch_size=4, device="cpu")
    assert printed[0] == want.summary()
    assert printed[1:] == [str(out / f"{n}.png") for n in (
        "image_weights", "text_weights", "in_text_compare")]
    assert all((out / f"{n}.png").stat().st_size > 0 for n in (
        "image_weights", "text_weights", "in_text_compare"))

    # provenance: image documents encoded and indexed by the port's CLIs
    art = tmp_path / "art"
    cli_encode.main(_common(data_root) + [
        "--encode-type", "image", "--dense-output-dir", str(art / "dense"),
        "--sparse-output-dir", str(art / "sparse")])
    dense_dir, sparse_dir = capsys.readouterr().out.split()
    cli_index.main(["--input", sparse_dir, "--index", str(art / "idx"),
                    "--device", "cpu"])
    capsys.readouterr()
    cli_stats.main(_common(data_root) + [
        "--mode", "provenance", "--passage-reps", dense_dir,
        "--sparse-index", str(art / "idx"), "--depth", "6", "--top-n", "4",
        "--out-dir", str(out)])
    printed = capsys.readouterr().out.splitlines()
    run = run_search(
        corpus.examples("full"), params, arch, tok, tmpl,
        query_type="text", sparse_cfg=SparseConfig(),
        search_cfg=SearchConfig(depth=6, alpha=0.5),
        dense_index=DenseFlatIndex.load(dense_dir, device="cpu"),
        impact_index=ImpactIndex.load(str(art / "idx"), device="cpu"),
        batch_size=4, device="cpu")
    want = statistics.fusion_provenance_statistics(
        run.dense_run, run.sparse_run, alpha=0.5, top_n=4)
    assert printed == [want.summary(), str(out / "provenance_ranks.png")]
    assert (out / "provenance_ranks.png").stat().st_size > 0

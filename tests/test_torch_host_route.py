"""PyTorch port: the host term-selection route, ``encode_examples(...,
device_select=False)`` with ``select_text_terms`` / ``select_image_terms``,
and the ``configs`` tail (``MeshConfig``, ``PipelineConfig``,
``config_to_json``, ``pipeline_config_from_json``, ``ModelConfig``'s
``lora_path`` / ``reps_loc``).

The encoders are ``tests/test_torch_offline_encode.py``'s tiny models (one
set of weights, drawn by the JAX package and carried across). Exact: the
host route's selected token ids and integer weights equal the device
route's and the JAX package's host route's, text as arrays (the candidate
order is fixed) and images as sets of (token id, weight) over the
positive weights (tied logits may cut the top-k either way, ROADMAP's rule
for ties at a cut); the dense vectors of the two port routes are equal and
within f32 ``atol=rtol=1e-5`` of JAX's. The JSON of either package's
``config_to_json`` reads back in the other without loss.
"""

import argparse
import dataclasses

import numpy as np
import pytest

from mllm_sparse_retrieval_tpu import configs as jconfigs
from mllm_sparse_retrieval_tpu.cli import common as jcommon
from mllm_sparse_retrieval_tpu.configs import SparseConfig as JSparseConfig
from mllm_sparse_retrieval_tpu.pipelines import encode as jencode
from mllm_sparse_retrieval_tpu.sparse import term_selection as jts
from mllm_sparse_retrieval_tpu_torch import configs
from mllm_sparse_retrieval_tpu_torch.cli import common
from mllm_sparse_retrieval_tpu_torch.configs import SparseConfig
from mllm_sparse_retrieval_tpu_torch.pipelines import encode as pencode
from mllm_sparse_retrieval_tpu_torch.sparse import term_selection as ts
from tests.test_torch_offline_encode import (  # noqa: F401 (fixture)
    BATCH, raw_loader, setup)
from tests.torch_threads import one_torch_thread  # noqa: F401

CFGS = [dict(), dict(is_filtered=False),
        dict(sparse_manual=True, sparse_length=16),
        dict(num_expanded_tokens=5),
        dict(is_filtered=False, sparse_manual=True, sparse_length=12,
             num_expanded_tokens=3)]


def _pairs(t):
    return {(int(i), int(w)) for i, w in zip(t.token_ids, t.weights)
            if w > 0}


def _run(setup, model, encode_type, cfg, device_select, jax_side=False,
         pixel_loader=None):
    corpus = setup["jcorpus" if jax_side else "corpus"]
    examples = corpus.examples_full() if encode_type == "text" \
        else corpus.examples_single()
    if jax_side:
        jp, ja, jt, jtm = setup[model]["j"]
        return jencode.encode_examples(
            examples, jp, ja, jt, jtm, encode_type=encode_type,
            sparse_cfg=JSparseConfig(**cfg), batch_size=BATCH,
            pixel_loader=pixel_loader, device_select=device_select)
    pp, pa, pt, ptm = setup[model]["p"]
    return pencode.encode_examples(
        examples, pp, pa, pt, ptm, encode_type=encode_type,
        sparse_cfg=SparseConfig(**cfg), batch_size=BATCH,
        pixel_loader=pixel_loader, device_select=device_select,
        device="cpu")


@pytest.mark.parametrize("cfg", CFGS)
def test_host_route_text_terms_equal_device_route_and_jax(setup, cfg):
    host = _run(setup, "fixed", "text", cfg, False)
    dev = _run(setup, "fixed", "text", cfg, True)
    jhost = _run(setup, "fixed", "text", cfg, False, jax_side=True)
    assert host.ids == dev.ids == jhost.ids
    np.testing.assert_array_equal(host.dense, dev.dense)
    np.testing.assert_allclose(host.dense, np.asarray(jhost.dense),
                               atol=1e-5, rtol=1e-5)
    for h, d, j in zip(host.selected_terms, dev.selected_terms,
                       jhost.selected_terms):
        for other in (d, j):
            np.testing.assert_array_equal(h.token_ids, other.token_ids)
            np.testing.assert_array_equal(h.weights, other.weights)
    assert host.sparse_vectors == dev.sparse_vectors == jhost.sparse_vectors


@pytest.mark.parametrize("model,cfg", [
    ("fixed", dict()), ("fixed", dict(num_expanded_tokens=3)),
    ("anyres", dict()),
    ("anyres", dict(sparse_manual=True, sparse_length=20,
                    num_expanded_tokens=4))])
def test_host_route_image_terms_equal_device_route_and_jax(setup, model,
                                                           cfg):
    loader = raw_loader if model == "anyres" else None
    host = _run(setup, model, "image", cfg, False, pixel_loader=loader)
    dev = _run(setup, model, "image", cfg, True, pixel_loader=loader)
    jhost = _run(setup, model, "image", cfg, False, jax_side=True,
                 pixel_loader=loader)
    assert host.ids == dev.ids == jhost.ids
    np.testing.assert_array_equal(host.dense, dev.dense)
    np.testing.assert_allclose(host.dense, np.asarray(jhost.dense),
                               atol=1e-5, rtol=1e-5)
    for h, d, j in zip(host.selected_terms, dev.selected_terms,
                       jhost.selected_terms):
        assert _pairs(h) == _pairs(d) == _pairs(j) and _pairs(h)


def test_host_selection_functions_equal_jax():
    rng = np.random.default_rng(5)
    vocab = 300
    filtered = np.sort(rng.choice(vocab, 120, replace=False)).astype(
        np.int32)
    words = {"dog": [5, 9], "red": [9, 77], "grass": [140, 141, 142]}
    encode_fn = lambda w: words.get(w, [])
    for trial in range(6):
        logits = rng.normal(size=vocab).astype(np.float32)
        logits[rng.integers(0, vocab, 20)] = 0.5      # ties
        for cfg in CFGS:
            got = ts.select_image_terms(logits, SparseConfig(**cfg),
                                        filtered)
            want = jts.select_image_terms(logits, JSparseConfig(**cfg),
                                          filtered)
            np.testing.assert_array_equal(got.token_ids, want.token_ids)
            np.testing.assert_array_equal(got.weights, want.weights)
            for text in ("a red dog on the grass", "the of a"):
                got = ts.select_text_terms(text, encode_fn, logits,
                                           SparseConfig(**cfg), filtered)
                want = jts.select_text_terms(text, encode_fn, logits,
                                             JSparseConfig(**cfg), filtered)
                np.testing.assert_array_equal(got.token_ids, want.token_ids)
                np.testing.assert_array_equal(got.weights, want.weights)
        vals, idx = ts._topk(logits, 17)
        jvals, jidx = jts._topk(logits, 17)
        np.testing.assert_array_equal(vals, jvals)
        np.testing.assert_array_equal(idx, jidx)


def _pipeline(pkg):
    return pkg.PipelineConfig(
        data=pkg.DataConfig(dataset_name="coco", per_device_batch_size=16),
        sparse=pkg.SparseConfig(sparse_manual=True, sparse_length=64,
                                num_expanded_tokens=7),
        model=pkg.ModelConfig(family=pkg.ModelFamily.LLAVA_NEXT_LLAMA3,
                              checkpoint_path="/ckpt", lora_path="/lora",
                              reps_loc=pkg.RepsLoc.AFTER_PAD,
                              dtype="float32"),
        search=pkg.SearchConfig(depth=50, alpha=0.3),
        train=pkg.TrainConfig(learning_rate=3e-4, grad_accum_steps=2),
        mesh=pkg.MeshConfig(data_parallel=2, model_parallel=4),
        dense_output_dir="/d", sparse_output_dir="/s")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_pipeline_config_json_round_trips_across_packages(direction):
    src, dst = (jconfigs, configs) if direction == "jax_to_port" \
        else (configs, jconfigs)
    for cfg in (src.PipelineConfig(), _pipeline(src)):
        text = src.config_to_json(cfg)
        back = dst.pipeline_config_from_json(text)
        assert isinstance(back, dst.PipelineConfig)
        assert dst.config_to_json(back) == text
        assert back == (dst.PipelineConfig() if cfg == src.PipelineConfig()
                        else _pipeline(dst))
    assert [f.name for f in dataclasses.fields(configs.ModelConfig)] == \
        [f.name for f in dataclasses.fields(jconfigs.ModelConfig)]


def test_model_config_from_args_sets_lora_path_and_reps_loc():
    parser = argparse.ArgumentParser()
    common.add_common_args(parser)
    jparser = argparse.ArgumentParser()
    jcommon.add_common_args(jparser)
    argv = ["--family", "llava_next_llama3", "--checkpoint-path", "/c",
            "--lora-path", "/l", "--reps-loc", "after_pad"]
    got = common.model_config_from_args(parser.parse_args(argv))
    want = jcommon.model_config_from_args(jparser.parse_args(argv))
    assert got.lora_path == "/l" and got.reps_loc == configs.RepsLoc.AFTER_PAD
    assert configs.config_to_json(got) == jconfigs.config_to_json(want)

"""Tiny configurations and mixes of the benchmark's cells, for running a
cell end to end on the CPU: the same files with every width cut down and
the port's tiny registry archs (``arch_overrides`` for what they lack)."""

from __future__ import annotations

import copy
import time

import numpy as np

from portbench import core, lexicon, run


def _special_ids(cfg, mix):
    tok = lexicon.build_tokenizer(lexicon.synthetic_lexicon(
        np.random.default_rng(0), mix["lexicon_words"]))
    for spec in cfg["special_tokens"].values():
        cfg[spec["key"]] = tok.special_ids[spec["token"]]
    return cfg


def qwen_config(native: bool = False) -> dict:
    c = copy.deepcopy(core.config("qwen2_5_vl_7b"))
    c["registry"] = "_tiny_qwen_debug_arch"
    c["registry_model_config"] = {"tiny_vocab_size": 512,
                                  "tiny_hidden_size": 128,
                                  "tiny_num_layers": 2, "tiny_num_heads": 4}
    c.update(hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, intermediate_size=512, vocab_size=512,
             rope_theta=10000.0, rms_norm_eps=1e-5)
    c["rope_scaling"] = {"type": "mrope", "mrope_section": [8, 4, 4]}
    c["vision_config"].update(hidden_size=64, depth=2, num_heads=4,
                              intermediate_size=128, out_hidden_size=128,
                              window_size=56, fullatt_block_indexes=[1])
    if native:
        c["arch_overrides"] = {"native_resolution": True,
                               "min_pixels": 3136, "max_pixels": 12544}
        c.update(min_pixels=3136, max_pixels=12544)
    else:
        c["arch_overrides"] = {"min_pixels": 3136, "max_pixels": 12544}
        c.update(min_pixels=3136, max_pixels=12544)
    return c


def internvl_config() -> dict:
    c = copy.deepcopy(core.config("internvl2_5_4b"))
    c["arch_overrides"] = {
        "vision": {"hidden_size": 32, "num_layers": 2, "num_heads": 2,
                   "intermediate_size": 64, "image_size": 28,
                   "patch_size": 14},
        "text": {"vocab_size": 512, "hidden_size": 128, "num_layers": 2,
                 "num_heads": 4, "num_kv_heads": 2,
                 "intermediate_size": 512}}
    c["llm_config"].update(vocab_size=512, hidden_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2, intermediate_size=512)
    c["vision_config"].update(hidden_size=32, num_hidden_layers=2,
                              num_attention_heads=2, intermediate_size=64,
                              image_size=28, patch_size=14)
    return c


def serve_mix() -> dict:
    m = copy.deepcopy(core.mix("serve_text"))
    m.update(lexicon_words=300, rate_qps=20, check_sample=8,
             trace_seconds=0.5, straggler_timeout_s=30)
    m["corpus"].update(docs=400, doc_terms=16)
    m["service"].update(max_batch=8, device_batch=8)
    m["warmup"] = {"bursts": 1, "open_loop_s": 0.3}
    return m


def index_mix(family: str) -> dict:
    m = copy.deepcopy(core.mix("index_images"))
    sizes = ([[56, 84], [84, 56], [70, 98], [98, 70]]
             if family == "qwen2_5_vl"
             else [[40, 60], [60, 40], [28, 28], [50, 90]])
    m.update(lexicon_words=300, image_sizes=sizes, pool=8, batch_size=2,
             chunk_batches=2, warmup_batches=1, trace_batches=1,
             check_sample=3)
    return m


def train_mix() -> dict:
    m = copy.deepcopy(core.mix("train_lora"))
    m.update(lexicon_words=300, pool=8, pairs=2, max_steps=16, log_every=2,
             image_sizes=[[40, 60], [60, 40], [28, 28], [50, 90]])
    return m


CELLS = {
    "qwen2_5_vl_7b.serve_text": (lambda: qwen_config(), serve_mix),
    "qwen2_5_vl_7b.index_images": (lambda: qwen_config(native=True),
                                   lambda: index_mix("qwen2_5_vl")),
    "internvl2_5_4b.index_images": (internvl_config,
                                    lambda: index_mix("internvl2_5")),
    "internvl2_5_4b.train_lora": (internvl_config, train_mix),
}


def tiny(cell_name: str):
    """(bench, cell, tiny config, tiny mix) of a cell of BENCHMARK.json."""
    bench = core.benchmark()
    cell = core.cell(bench, cell_name)
    make_cfg, make_mix = CELLS[cell_name]
    mix = make_mix()
    return bench, cell, _special_ids(make_cfg(), mix), mix


def run_tiny(cell_name: str, seed: int = 12345678901, seconds: float = 1.0,
             trace: bool = False):
    bench, cell, cfg, mix = tiny(cell_name)
    return run.execute(bench, cell, seed, seconds, trace, "cpu",
                       time.perf_counter(), config=cfg, mix=mix)

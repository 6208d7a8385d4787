"""Cells, configurations, mixes, limits and metric readers are found by
name; BENCHMARK.json keeps to the benchmark's contract; a cell, a
configuration, a mix and a metric can be added as new files alone."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import archs, core, lexicon

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench():
    return core.benchmark()


def test_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= int(bench["run_seconds"]) <= 51
    assert len(json.dumps(bench)) < 64 * 1024
    for word in bench["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_units_and_entries(bench):
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        for w in m.get("workloads", []):
            wm = e2e[m["moves"]]
            assert "workloads" not in wm or w in wm["workloads"]


def test_every_cell_resolves(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    seen = set()
    for cell in bench["workloads"]:
        assert cell["chips"] in (1, 4)
        assert len(cell["why"]) <= 200
        key = (cell["config"], cell["traffic"])
        assert key not in seen
        seen.add(key)
        entry = configs[cell["config"]]
        cfg = core.config(cell["config"])
        assert entry["file"] == f"portbench/configs/{cell['config']}.json"
        assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
        assert entry["source"] == cfg["source"]
        mix = core.mix(cell["traffic"])
        core.kind_module(mix["kind"])
        assert core.limits(cell["name"])
        e2e = [m["name"] for m in core.e2e_metrics(bench, cell["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = core.per_layer_metrics(bench, cell["name"])
        assert layer
        for m in layer:
            assert callable(core.metric_reader(m["name"]).read)
    assert set(configs) == {c["config"] for c in bench["workloads"]}


@pytest.mark.parametrize("name", ["qwen2_5_vl_7b", "internvl2_5_4b"])
def test_configuration_matches_the_port(name):
    cfg = core.config(name)
    tok = lexicon.build_tokenizer(lexicon.synthetic_lexicon(
        __import__("numpy").random.default_rng(0), 8192))
    arch = archs.port_arch(cfg, tok.special_ids)
    assert archs.mismatches(cfg, arch) == []


def test_a_changed_width_is_refused():
    cfg = core.config("qwen2_5_vl_7b")
    cfg["intermediate_size"] += 1
    tok = lexicon.build_tokenizer(lexicon.synthetic_lexicon(
        __import__("numpy").random.default_rng(0), 8192))
    with pytest.raises(ValueError, match="intermediate_size"):
        archs.port_arch(cfg, tok.special_ids)


def test_adding_files_adds_a_cell_a_mix_and_a_metric(tmp_path):
    """In a copy: a new mix of an existing kind, a new cell on it, a new
    per-layer metric with its reader; the lookup finds them with no code
    changed."""
    root = tmp_path / "checkout"
    shutil.copytree(core.BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = core.benchmark()
    mix = core.mix("serve_text")
    mix["rate_qps"] = mix["rate_qps"] * 5 // 4
    (root / "portbench/traffic/serve_text_over.json").write_text(
        json.dumps(mix))
    bench["workloads"].append({
        "name": "qwen2_5_vl_7b.serve_text_over", "config": "qwen2_5_vl_7b",
        "traffic": "serve_text_over", "chips": 1, "why": "above capacity"})
    bench["end_to_end"][1]["workloads"].append(
        "qwen2_5_vl_7b.serve_text_over")
    bench["per_layer"].append({
        "name": "serve.batches", "unit": "batches", "better": "lower",
        "source": "program_counter", "layer": "serving/service.py",
        "moves": "queries_per_s",
        "workloads": ["qwen2_5_vl_7b.serve_text_over"]})
    (root / "portbench/metrics/serve.batches.py").write_text(
        "def read(layer):\n    return layer.get('serve_batches')\n")
    shutil.copy(core.BENCH_DIR / "limits/qwen2_5_vl_7b.serve_text.json",
                root / "portbench/limits/qwen2_5_vl_7b.serve_text_over.json")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "from portbench import core\n"
        "b = core.benchmark()\n"
        "c = core.cell(b, 'qwen2_5_vl_7b.serve_text_over')\n"
        "m = core.mix(c['traffic'])\n"
        "print(m['kind'], m['rate_qps'], len(core.limits(c['name'])),\n"
        "      [x['name'] for x in core.per_layer_metrics(b, c['name'])],\n"
        "      core.metric_reader('serve.batches').read("
        "{'serve_batches': 7}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    kind, rate, _, metrics, batches = out.stdout.split(" ", 4)
    assert kind == "serve_text"
    assert "serve.batches" in metrics and batches.strip().endswith("7")


def test_run_refuses_without_a_card_or_the_port(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's files
    prints no result and exits non-zero (here also for want of a card)."""
    root = tmp_path / "bare"
    shutil.copytree(core.BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(core.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "qwen2_5_vl_7b.serve_text", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=root, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

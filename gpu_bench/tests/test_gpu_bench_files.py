"""The benchmark is data: every cell, configuration, traffic mix and
per-layer metric named in BENCHMARK.json loads from its own file, and the
file keeps to the contract's shapes.  Nothing here needs a card."""
from __future__ import annotations

import ast
import json
import os
import re

import pytest

import tiny  # noqa: F401  (puts the checkout root on sys.path)
from gpu_bench import cells, harness

ROOT = tiny.ROOT
BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
GPU_BENCH = os.path.join(ROOT, "gpu_bench")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads_from_its_files(w):
    cell = cells.load_cell(w["name"])
    cfg = cells.build_config(cell, seed=2 ** 31 + 7)
    assert cfg.seed == 2 ** 31 + 7
    assert set(cell["cell_file"]["limits"]) >= {
        "start_gap", "prio_gap", "grad_gap", "dparam_gap", "act_q_gap",
        "act_h_gap", "act_params_gap"}
    if cfg.in_graph_per:
        assert "bad_draws" in cell["cell_file"]["limits"]


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cuts(c):
    with open(os.path.join(ROOT, c["file"])) as f:
        conf = json.load(f)
    assert conf["source"] == c["source"]
    assert conf["reduced"] == c["reduced"]
    assert set(conf["published"]) == set(conf["reduced"])
    assert conf["assumed"]
    harness._arith(conf["arith"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader(m):
    assert callable(harness._reader(m["name"]))
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    moved = e2e[m["moves"]]
    for w in m.get("workloads", [x["name"] for x in BENCH["workloads"]]):
        assert "workloads" not in moved or w in moved["workloads"]


def test_benchmark_json_keeps_the_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_holds_no_list_of_cells_or_metrics():
    src = _read(os.path.join(GPU_BENCH, "run.py")) + _read(
        os.path.join(GPU_BENCH, "harness.py"))
    for x in BENCH["workloads"] + BENCH["per_layer"] + BENCH["configs"]:
        assert x["name"] not in src


def _read(path):
    with open(path) as f:
        return f.read()


def _imports(path):
    tree = ast.parse(_read(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    for d, _, files in os.walk(GPU_BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "r2d2_tpu"}
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in bad, (path, name)


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(GPU_BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for name in _imports(os.path.join(ref, f)):
                assert name.split(".")[0] not in ("r2d2_tpu_torch",
                                                  "r2d2_tpu"), (f, name)
                if name.startswith("gpu_bench"):
                    assert name.startswith("gpu_bench.reference"), (f, name)

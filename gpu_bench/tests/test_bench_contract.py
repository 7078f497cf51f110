"""BENCHMARK.json against the benchmark's contract, the FLOP count
against the kernel table's bound, and the import rules: no JAX in a run,
nothing of the program in the reference."""

import ast
import json
import os
import re

import pytest

import toy
from gpu_bench import core
from gpu_bench.costs import bound_s, mlp_v0

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    path = os.path.join(toy.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    b = toy.bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert b["paths"] == ["gpu_bench"]
    assert b["command"] == ["python3", "gpu_bench/run.py"]
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("gpu_bench/")
        assert os.path.exists(os.path.join(toy.ROOT, c["file"]))
        assert c["reduced"] == []
    cells = {w["name"]: w for w in b["workloads"]}
    assert len(cells) == len(b["workloads"])
    assert {w["config"] for w in b["workloads"]} == set(configs)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        mix = toy.load(toy.HERE, "traffic", f"{w['traffic']}.json")
        assert os.path.exists(os.path.join(toy.HERE, "drivers",
                                           f"{mix['driver']}.py"))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert os.path.exists(os.path.join(toy.HERE, "metrics",
                                           f"{m['name']}.py"))
        for w in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or \
                w in e2e[m["moves"]]["workloads"]
        if m["name"].endswith("roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        reported = [m for m in b["end_to_end"] if "workloads" not in m or
                    w in m["workloads"]]
        assert len(reported) >= 2
        assert any(w in m["workloads"] for m in b["per_layer"])


def test_k8_bound_is_the_kernel_tables():
    """A 16384 x 128 K8 chunk: 3.195 ms at 165 TFLOP/s (PERF.md's table)."""
    t = bound_s(mlp_v0.render_flops(16384 * 128),
                mlp_v0.render_bytes(16384, 128))
    assert round(t * 1e3, 3) == 3.195
    assert mlp_v0.FLOPS == 2 * 125696


@pytest.mark.parametrize("modules,found", [
    (["jax", "jax.numpy", "numpy"], ["jax"]),
    (["jaxlib.xla_client", "flax.linen", "optax"],
     ["flax", "jaxlib", "optax"]),
    (["mvsnerf_tpu", "mvsnerf_tpu.ops.sweep"], ["mvsnerf_tpu"]),
    (["mvsnerf_tpu_torch", "mvsnerf_tpu_torch.ops", "torch"], []),
])
def test_the_import_check_compares_whole_top_level_names(modules, found):
    assert core.forbidden_modules(modules) == found


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for root, _, files in os.walk(os.path.join(toy.HERE, sub)):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))


def test_the_harness_imports_no_jax():
    for path in _sources():
        assert not set(_imports(path)) & set(core.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert set(_imports(path)) <= {"__future__", "math", "torch"}, path
        assert core.PROGRAM not in open(path).read()

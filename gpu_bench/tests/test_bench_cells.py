"""Every cell of BENCHMARK.json run end to end at toy size on the CPU, on
the program's plain PyTorch twins: the result line has the contract's
shape, the plain reference agrees with the program, and each fault the
cell can have, planted in the timed path, turns `correct` false.

    python -m pytest gpu_bench/tests -q      (~1 min on the CPU)
"""

import importlib
import json

import pytest

import toy
from gpu_bench import run

WORKLOADS = [w["name"] for w in toy.bench()["workloads"]]
SEED = 2 ** 31 + 977


def run_toy(workload, seed=SEED, trace=False, **kw):
    cfg, mix = toy.toy(workload)
    return run.run_cell(toy.bench(), workload, seed, 0.5, trace,
                        device="cpu", config=cfg, traffic=mix, **kw)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_and_agrees_with_the_reference(workload):
    res = run_toy(workload)
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in toy.bench()["end_to_end"]
            if run.applies(m, workload)}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for name, c in line["compared"].items():
        assert c["value"] <= c["limit"], (name, c)
    assert line["correct"] is True


def test_traced_run_on_the_cpu_reads_no_device_metric():
    """Without a card there is no trace: the readers return nothing and
    no device number is made up."""
    res = run_toy("dtu_v0.view", trace=True)
    assert res["metrics"] == {} and "breakdown" not in res


def faults(workload):
    """The faults the cell's driver declares, {name: plant(monkeypatch)}."""
    _, mix = toy.toy(workload)
    return importlib.import_module(
        f"gpu_bench.drivers.{mix['driver']}").FAULTS


CASES = [(w, f) for w in WORKLOADS for f in faults(w)]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_has_a_fault(workload):
    assert faults(workload)


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    faults(workload)[fault](monkeypatch)
    res = run_toy(workload)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["compared"].values())

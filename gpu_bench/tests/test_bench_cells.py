"""Every cell of BENCHMARK.json run end to end at toy size on the CPU, on
the program's plain PyTorch twins: the result line has the contract's
shape, the plain reference agrees with the program, and each fault the
cell can have, planted in the timed path, turns `correct` false.

    python -m pytest gpu_bench/tests -q      (~1 min on the CPU)
"""

import json

import pytest
import torch

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


def _alter_answers(monkeypatch, cls, attr):
    orig = getattr(cls, attr)

    def altered(self, *a, **kw):
        out = orig(self, *a, **kw)
        return dict(out, rgb=out["rgb"] + 1e-3)

    monkeypatch.setattr(cls, attr, altered)


def _unchanged_state(monkeypatch, cls):
    """A step that computes its loss and update, then leaves the
    parameters as they were."""
    orig = cls._step

    def step(self, *a, **kw):
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        before = [p.detach().clone() for p in params]
        out = orig(self, *a, **kw)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)
        return out

    monkeypatch.setattr(cls, "_step", step)


def _half_batch(monkeypatch, cls):
    """Half of the batch left out: the loss is the mean over the rest."""
    orig = cls._step

    def step(self, *a, **kw):
        batch, xs, ys, u = a[:4]
        n = len(xs) // 2
        return orig(self, batch, xs[:n], ys[:n], u[:n], *a[4:], **kw)

    monkeypatch.setattr(cls, "_step", step)


def _finetune_cls():
    from mvsnerf_tpu_torch.train.finetune import FinetuneSystem
    return FinetuneSystem


def _train_cls():
    from mvsnerf_tpu_torch.train.generalizable import GeneralizableSystem
    return GeneralizableSystem


def _evaluator_cls():
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator
    return Evaluator


FAULTS = {
    "dtu_v0.view": {"answer_altered": lambda mp: _alter_answers(
        mp, _evaluator_cls(), "render")},
    "llff_v0.video": {"answer_altered": lambda mp: _alter_answers(
        mp, _finetune_cls(), "render_image")},
    "dtu_v0.train": {
        "unchanged_state": lambda mp: _unchanged_state(mp, _train_cls()),
        "half_batch": lambda mp: _half_batch(mp, _train_cls())},
}
CASES = [(w, f) for w in WORKLOADS for f in FAULTS[w]]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    FAULTS[workload][fault](monkeypatch)
    res = run_toy(workload)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["compared"].values())

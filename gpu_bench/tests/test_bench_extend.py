"""A configuration that differs from one of the benchmark's only by its
model joins through new files and new entries of BENCHMARK.json alone:
the program flags and the cost module come from its configuration file,
its faults from its driver, a norm of its MLP from its reference's
`param_table`, a new kernel's launch counter from the program's `ops`,
and its roofline from a metric file of a few lines. The seeded weights,
counters and readings of the existing cells stay as they were.

    python -m pytest gpu_bench/tests/test_bench_extend.py -q   (~15 s)
"""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest

import toy
from gpu_bench import core, readers
from gpu_bench.costs import mlp_v0, mvsnet
from gpu_bench.drivers import train, video, view
from gpu_bench.reference import mvsnerf_v0
from test_bench_trace import trace

SEED = 2 ** 31 + 977
NEW_CELL = "dtu_v0_d6.view"
# the metric file of the new cell's render body: a launch counter by the
# name `core.program_counters` derives, a cost module by its name
ROOFLINE_FILE = '''\
"""Per cent of its roofline reached by the render body K8."""
from gpu_bench.readers import K8, render_roofline


def read(ctx):
    return render_roofline(ctx, K8, "render_v0_feats.launches", "mlp_v0")
'''


def extended(root):
    """The benchmark copied under `root`, with one more configuration
    (`dtu_v0` under another name, its MLP's depth stated as a program
    flag) and one more cell under the `view` traffic, added through new
    files and entries alone: the one entry that changes is
    `view_p90_ms`'s list of cells."""
    shutil.copytree(toy.HERE, os.path.join(root, "gpu_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(toy.ROOT, "pytest.ini"), root)
    b = toy.bench()
    cfg = dict(toy.load(toy.HERE, "configs", "dtu_v0.json"),
               program_flags=["--netdepth", "6"])
    with open(os.path.join(root, "gpu_bench", "configs", "dtu_v0_d6.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "gpu_bench", "metrics",
                           "k8_roofline.view_d6.py"), "w") as f:
        f.write(ROOFLINE_FILE)
    b["configs"].append({
        "name": "dtu_v0_d6", "source": "https://arxiv.org/abs/2103.15595",
        "file": "gpu_bench/configs/dtu_v0_d6.json", "reduced": [],
        "why": "dtu_v0 with its MLP's depth stated as a program flag"})
    b["workloads"].append({
        "name": NEW_CELL, "config": "dtu_v0_d6", "traffic": "view",
        "chips": 1, "why": "dtu_v0.view's traffic on dtu_v0_d6"})
    for m in b["end_to_end"]:
        if m["name"] == "view_p90_ms":
            m["workloads"].append(NEW_CELL)
    b["per_layer"].append({
        "name": "k8_roofline.view_d6", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "kernels",
        "moves": "view_p90_ms", "workloads": [NEW_CELL]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f, indent=1)
    return b


def test_a_new_cell_runs_through_the_unedited_tests(tmp_path):
    """The copy's own cell and contract tests, none of them edited,
    collect the new cell, see it agree with the reference, and see its
    driver's fault turn it not correct."""
    extended(str(tmp_path))
    env = dict(os.environ, PYTHONPATH=toy.ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "gpu_bench/tests/test_bench_cells.py",
         "gpu_bench/tests/test_bench_contract.py",
         "-k", f"{NEW_CELL} or keeps_to_the_contract"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert re.search(r"\b4 passed\b", out.stdout), out.stdout[-4000:]


def test_toy_size_keeps_the_configurations_program_flags(tmp_path,
                                                          monkeypatch):
    b = extended(str(tmp_path))
    monkeypatch.setattr(toy, "HERE", os.path.join(str(tmp_path),
                                                  "gpu_bench"))
    monkeypatch.setattr(toy, "bench", lambda: b)
    cfg, mix = toy.toy(NEW_CELL)
    assert cfg["program_flags"] == ["--netdepth", "6"]
    assert mix["flags"] == toy.TOY_FLAGS


def test_program_flags_come_between_the_drivers_and_the_traffics():
    cfg, mix = toy.toy("dtu_v0.view")
    cfg = dict(cfg, program_flags=["--netdepth", "5", "--chunk", "64"])
    mix = dict(mix, flags=[*mix["flags"], "--chunk", "128"])
    d = view.Driver(cfg, mix, SEED, "cpu")
    try:
        args = d.program_args(["--dataset_name", "dtu_ft",
                               "--netdepth", "4"])
    finally:
        d.drop_ckpt()
    assert (args.dataset_name, args.netdepth, args.chunk) == \
        ("dtu_ft", 5, 128)


def test_a_marked_layer_norm_is_drawn_as_a_norm():
    table = {"net": [("nerf.lin.weight", (64, 3)), ("nerf.lin.bias", (64,)),
                     ("nerf.ln.weight", (64,), core.NORM),
                     ("nerf.ln.bias", (64,), core.NORM)]}
    w = core.make_weights(table, SEED, "cpu")["net"]
    scale, shift = w["nerf.ln.weight"], w["nerf.ln.bias"]
    assert ((scale - 1).abs() <= 0.1).all() and (scale - 1).abs().max() > .05
    assert (shift.abs() <= 0.1).all() and shift.abs().max() > 0.05
    assert (w["nerf.lin.bias"].abs() <= 3 ** -0.5).all()
    assert w["nerf.lin.bias"].abs().max() > 0.3
    unmarked = {"net": [item[:2] for item in table["net"]]}
    with pytest.raises(ValueError, match="nerf.ln.weight"):
        core.make_weights(unmarked, SEED, "cpu")


# sha256 of the v0 table's seeded tensors on the CPU, drawn by the
# harness before norms could be marked
V0_WEIGHTS = {
    0: "67e506d14a8922b4d4846b8a3bcd2308d482ca25d954ca0e1648fdfdc6e00d10",
    2 ** 31 + 977:
        "b883edaf878ef222691440a3b6e08c5d969322e657a7dc88dd4d9dc0840d77fa",
    2 ** 31 + 7:
        "bd9125fa1bb45155527300a6537f33ecc061e99d23e5c0a3658c57830fbf976d",
}


@pytest.mark.parametrize("seed", sorted(V0_WEIGHTS))
def test_the_v0_weights_are_drawn_as_before(seed):
    h = hashlib.sha256()
    for entry in core.make_weights(mvsnerf_v0.param_table(), seed,
                                   "cpu").values():
        for key, t in entry.items():
            h.update(key.encode())
            h.update(t.numpy().tobytes())
    assert h.hexdigest() == V0_WEIGHTS[seed]


def test_every_counter_of_the_programs_ops_is_counted():
    """Each `+= 1` on a counter in the program's `ops` sources names a
    counter that `launch_counts` reports; the kernel numbers read what
    the derived names read."""
    import mvsnerf_tpu_torch.ops as ops
    counts = core.launch_counts()
    found = 0
    for path in sorted(os.listdir(ops.__path__[0])):
        if not path.endswith(".py"):
            continue
        src = open(os.path.join(ops.__path__[0], path)).read()
        for fn, attr in re.findall(r"^\s*(\w+)\.(\w+)\s*\+=\s*1\b", src,
                                   re.M):
            assert f"{fn}.{attr}" in counts, (path, fn, attr)
            found += 1
        for name in re.findall(r"^\s*(\w+)\[[^\]]+\]\s*\+=\s*1\b", src,
                               re.M):
            keys = [k for k in counts
                    if k.startswith(f"{path[:-3]}.{name}.")]
            assert keys, (path, name)
            found += 1
    assert found >= 12
    legacy = {"k1": "sweep_cost_volume.launches",
              "k2": "sweep_cost_volume.bwd_launches",
              "k4": "color_warp.launches", "k4_bwd": "color_warp.bwd_launches",
              "k5": "sample_volume.launches",
              "k5_bwd": "sample_volume.bwd_launches",
              "k6": "render_v0.launches", "k6b": "render_v0.baked_launches",
              "k7": "mlp_v0_train.launches",
              "k7_bwd": "mlp_v0_train.bwd_launches",
              "k8": "render_v0_feats.launches",
              **{f"k10_{k}": f"costreg_conv.launches.{k}"
                 for k in ("s1", "s2", "up", "wgrad")}}
    assert set(legacy) < set(counts)
    from mvsnerf_tpu_torch.ops import render_fused
    render_fused.render_v0_feats.launches += 3
    try:
        after = core.launch_counts()
    finally:
        render_fused.render_v0_feats.launches -= 3
    for k, derived in legacy.items():
        assert after[k] == after[derived]
    assert after["k8"] - counts["k8"] == 3


# `readers.k8_roofline` of the harness before `render_roofline` existed,
# on test_bench_trace's made-up trace (K8: 2 launches, 40 ms)
K8_ROOFLINE = [({"k8": 4}, 1000, 128, 0.2437740606060606),
               ({"k8": 7}, 640 * 512, 64, 22.82282405125541)]


@pytest.mark.parametrize("launches,rays,samples,want", K8_ROOFLINE)
def test_render_roofline_with_k8s_arguments_reads_as_k8_roofline(
        launches, rays, samples, want):
    ctx = {"trace": trace(), "window_s": 0.1, "launches": launches,
           "stats": {"rendered_rays": rays},
           "config": {"samples_per_ray": samples}}
    got = readers.render_roofline(ctx, readers.K8, "k8", "mlp_v0")
    assert got == want and readers.k8_roofline(ctx) == want
    assert readers.render_roofline(ctx, readers.K8, "k_new", "mlp_v0") \
        is None


STUB = types.SimpleNamespace(render_flops=lambda n: 7.0 * n,
                             train_flops=lambda n: 11.0 * n)


@pytest.mark.parametrize("module,stats", [
    (view, {"requests": 2}), (video, {"frames": 2}), (train, {"steps": 2})])
def test_work_flops_take_the_configurations_cost_module(monkeypatch,
                                                         module, stats):
    monkeypatch.setitem(sys.modules, "gpu_bench.costs.mlp_stub", STUB)
    workload = {view: "dtu_v0.view", video: "llff_v0.video",
                train: "dtu_v0.train"}[module]
    cfg, mix = toy.toy(workload)
    default = module.Driver(cfg, mix, SEED, "cpu")
    stub = module.Driver(dict(cfg, costs="mlp_stub"), mix, SEED, "cpu")
    assert stub.mlp_costs is STUB and default.mlp_costs.__name__ == \
        "gpu_bench.costs.mlp_v0"
    W, H = cfg["img_wh"]
    S, B = cfg["samples_per_ray"], 64
    for d in (default, stub):
        d.W, d.H, d.batch, d.S = W, H, B, S
    hw, planes, pad = cfg["img_wh"][::-1], cfg["planes"], cfg["pad"]

    def want(mlp):
        return 2 * {
            view: mvsnet.forward_flops(3, hw, planes, pad)
            + mlp.render_flops(W * H * S),
            video: mlp.render_flops(W * H * S),
            train: mvsnet.train_flops(3, hw, planes, pad)
            + mlp.train_flops(B * S)}[module]

    assert stub.work_flops(stats) == want(STUB)
    assert default.work_flops(stats) == want(mlp_v0)

#!/usr/bin/env python3
"""One run of one cell of the benchmark of `mvsnerf_tpu_torch` on a card.

    python3 gpu_bench/run.py --workload dtu_v0.view --seed 7 --seconds 30 \
        --trace 0

from the root of a checkout. `BENCHMARK.json` names the cell's
configuration (`gpu_bench/configs/<config>.json`, with the plain reference,
the program flags and the cost module it names) and traffic
(`gpu_bench/traffic/<traffic>.json`, whose `driver` is a module of
`gpu_bench/drivers/`); each per-layer metric is read by
`gpu_bench/metrics/<name>.py`. A run builds the program from the seed,
warms up every shape the cell uses (set-up), measures for `--seconds`
(with `--trace 1` under `torch.profiler`, reporting the per-layer
metrics instead of the end-to-end ones), then checks what the timed path
produced against the plain reference. Its last line on standard output is
one JSON object: correct, attempted, failed, metrics, device, with
`--trace 1` a breakdown, and last the numbers compared with their limits,
which also end standard error.

It exits non-zero and prints no result without enough CUDA cards, or
when the process holds jax, jaxlib, flax, optax or the JAX package
`mvsnerf_tpu` once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from gpu_bench import core  # noqa: E402

T_IMPORTED = time.time()


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str) -> dict:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    return cells[workload]


def metric_reader(name: str):
    path = os.path.join(core.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "gpu_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device=None, t_start: float | None = None,
             config: dict | None = None, traffic: dict | None = None,
             after=None) -> dict:
    """Set up, measure and check one cell; returns the result object.
    `device`, `config` and `traffic` are for the tests (a toy-size cell on
    the CPU); `after(driver)`, called once the check is done, for the
    control's readings (its value goes under the result's `after`)."""
    spec = cell_spec(bench, workload)
    cfg = config or load_json(core.HERE, "configs", f"{spec['config']}.json")
    mix = traffic or load_json(core.HERE, "traffic",
                               f"{spec['traffic']}.json")
    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    driver = importlib.import_module(
        f"gpu_bench.drivers.{mix['driver']}").Driver(cfg, mix, seed, dev)
    t0 = time.time() if t_start is None else t_start
    spans = core.Spans(trace and on_card)
    # where set-up goes: seconds to each mark from the one before
    marks = [("start", t0)]
    if t0 < T_IMPORTED:  # started with the process
        marks.append(("imports", T_IMPORTED))
    if on_card:
        torch.cuda.init()
        torch.cuda.synchronize()
        marks.append(("cuda", time.time()))
    driver.mark = lambda name: marks.append((name, time.time()))
    driver.setup(spans)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.time() - t0
    driver.mark("end")

    launches0 = core.launch_counts()
    prof = None
    if trace:
        # a traced window may be shorter: the profiler's trace of a long
        # one takes minutes to read
        seconds = min(seconds, mix.get("trace_seconds", seconds))
    if trace and on_card:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA],
            record_shapes=mix.get("trace_shapes", False))
        prof.__enter__()
    t_win = time.perf_counter()
    stats = driver.window(seconds, spans)
    if on_card:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t_win
    if prof is not None:
        prof.__exit__(None, None, None)
    launches = {k: v - launches0.get(k, 0)
                for k, v in core.launch_counts().items()}

    dev_info = {"platform": "gpu" if on_card else dev.type,
                "kind": torch.cuda.get_device_name(dev) if on_card
                else "cpu", "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
                if on_card else 0}
    result = {"correct": False, "attempted": stats["attempted"],
              "failed": stats["failed"], "metrics": {}, "device": dev_info}
    if trace:
        tr = core.Trace(prof) if prof is not None else None
        ctx = {"workload": workload, "config": cfg, "traffic": mix,
               "stats": stats, "spans": spans, "trace": tr,
               "window_s": window_s, "launches": launches,
               "work_flops": driver.work_flops(stats)}
        for m in bench["per_layer"]:
            if applies(m, workload):
                value = metric_reader(m["name"])(ctx)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": value,
                                                    "unit": m["unit"]}
        if tr is not None:
            dev_info["busy_s"] = tr.busy_s
            dev_info["window_s"] = window_s
            result["breakdown"] = tr.breakdown()
    else:
        values = dict(driver.end_to_end(stats, window_s), setup_s=setup_s)
        for m in bench["end_to_end"]:
            if applies(m, workload):
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}

    driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    compared = driver.check()
    result["correct"] = bool(
        stats["attempted"] > 0 and stats["failed"] == 0 and all(
            c["value"] <= c["limit"] for c in compared.values()))
    result["setup_split"] = {name: round(t - marks[i][1], 3) for i, (
        name, t) in enumerate(marks[1:])}
    result["compared"] = compared
    if after is not None:
        result["after"] = after(driver)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(core.ROOT, "BENCHMARK.json")
    chips = cell_spec(bench, args.workload)["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"needs {chips} CUDA card(s); torch sees {cards}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START)
    found = core.forbidden_modules()
    if found:
        print(f"the run's process holds {found}", file=sys.stderr)
        return 3
    print("set-up split (s): " + ", ".join(
        f"{k} {v}" for k, v in result["setup_split"].items()),
        file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

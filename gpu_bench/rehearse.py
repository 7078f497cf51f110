#!/usr/bin/env python3
"""Many seeds of one cell in one process, on the card: the readings that
set the limits of `correct` and show that they hold.

    python3 gpu_bench/rehearse.py --workload dtu_v0.train \
        --seeds 11 12 13 --traced 12 --seconds 3 --control

Each seed runs `run.run_cell` as `run.py` would (set-up, a short window,
traced for the seeds under `--traced`, the check) and prints one JSON line
with its compared numbers; with `--control`, also the same numbers for the
reference computed in TF32 in the program's place, and for the faults the
cell can have (`Driver.fault_readings`). The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from gpu_bench import core, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--traced", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = run.load_json(core.ROOT, "BENCHMARK.json")

    def readings(driver):
        out = {"control": driver.control_readings(),
               "faults": driver.fault_readings()}
        if hasattr(driver, "leaf_detail"):
            out["leaves"] = driver.leaf_detail()
        return out

    for seed in args.seeds:
        t0 = time.time()
        res = run.run_cell(bench, args.workload, seed, args.seconds,
                           seed in args.traced, t_start=t0,
                           after=readings if args.control else None)
        line = {"workload": args.workload, "seed": seed,
                "trace": seed in args.traced, "correct": res["correct"],
                "attempted": res["attempted"], "failed": res["failed"],
                "compared": {k: v["value"] for k, v in
                             res["compared"].items()},
                "metrics": {k: v["value"] for k, v in
                            res["metrics"].items()},
                "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                "busy_s": res["device"].get("busy_s"),
                "setup_split": res["setup_split"],
                "run_s": time.time() - t0}
        if "after" in res:
            line.update(res["after"])
        if "breakdown" in res:
            line["breakdown"] = res["breakdown"]
        print(json.dumps(line), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    found = core.forbidden_modules()
    if found:
        print(f"the process holds {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Toy sizes of the benchmark's cells, for the CPU tests: the cells'
configurations and traffic with small images, 8 samples a ray, pad 2,
a batch of 64 and short segments (the program takes them as flags)."""

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
TOY_FLAGS = ["--N_samples", "8", "--pad", "2", "--batch_size", "64"]


def load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def bench():
    return load(ROOT, "BENCHMARK.json")


def toy(workload: str, card: bool = False):
    """(config, traffic) of a cell at toy size; for the `card`, small
    images at the program's own samples, pad and batch (its kernels'
    shapes)."""
    spec = {w["name"]: w for w in bench()["workloads"]}[workload]
    cfg = load(HERE, "configs", f"{spec['config']}.json")
    mix = load(HERE, "traffic", f"{spec['traffic']}.json")
    w = 160 if cfg["img_wh"][0] == 640 else 96
    cfg = dict(cfg, img_wh=[w, w * cfg["img_wh"][1] // cfg["img_wh"][0]])
    mix = dict(mix, scenes=1, segment_steps=2, frames=4)
    if not card:
        cfg.update(samples_per_ray=8, pad=2)
        mix.update(flags=TOY_FLAGS)
    return cfg, mix

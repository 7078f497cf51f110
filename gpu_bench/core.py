"""What every cell shares: seeds, seeded weights handed to the program
through a reference-format checkpoint, the program's flags, host spans,
the reading of a `torch.profiler` trace, and the comparisons that decide
`correct`.

Nothing here imports the measured program at module level.
"""

from __future__ import annotations

import contextlib
import math
import os
import re

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "mvsnerf_tpu_torch"
# top-level module names no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mvsnerf_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name, compared whole, is one of
    FORBIDDEN."""
    names = {m.split(".", 1)[0] for m in (modules if modules is not None
                                          else list(__import__("sys")
                                                    .modules))}
    return sorted(n for n in names if n in FORBIDDEN)


def seeds(seed: int, n: int) -> list:
    """n independent 31-bit seeds from a run's seed (any size)."""
    ss = np.random.SeedSequence(int(seed))
    return [int(s) >> 1 for s in ss.generate_state(n, np.uint32)]


# --------------------------------------------------------------- weights ---

def make_weights(table: dict, seed: int, device) -> dict:
    """{checkpoint entry: {key: tensor}} from one draw on the device: a
    weight or bias uniform in +-1/sqrt(fan_in) (PyTorch's default), a
    norm's scale 1 +- 0.1 and shift +- 0.1, the unread running statistics
    at their defaults. `table` is the reference's `param_table()`."""
    shapes = [s for entry in table.values() for _, s in entry]
    sizes = [math.prod(s) for s in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, pos, leaf = {}, 0, 0
    for entry, items in table.items():
        out[entry] = {}
        for key, shape in items:
            size = sizes[leaf]
            u = flat[pos:pos + size].reshape(shape)
            pos, leaf = pos + size, leaf + 1
            if key.endswith("running_mean"):
                t = torch.zeros(shape, device=device)
            elif key.endswith("running_var"):
                t = torch.ones(shape, device=device)
            elif key.endswith("num_batches_tracked"):
                t = torch.zeros((), dtype=torch.long, device=device)
            elif ".bn." in key or re.search(r"conv(7|9|11)\.1\.", key):
                t = 1 + 0.1 * u if key.endswith("weight") else 0.1 * u
            else:
                fan_in = size // shape[0] if len(shape) > 1 else None
                if fan_in is None:  # a bias: its layer's weight's fan-in
                    w = dict(items)[key[:-len("bias")] + "weight"]
                    fan_in = math.prod(w) // w[0]
                t = u / math.sqrt(fan_in)
            out[entry][key] = t.contiguous()
    return out


def flat_params(weights: dict) -> dict:
    return {k: v for entry in weights.values() for k, v in entry.items()}


def write_checkpoint(weights: dict, path: str) -> str:
    """A reference-format checkpoint (the authors' `.tar` layout) the
    program's `--ckpt` reads."""
    torch.save({k: {n: t.cpu() for n, t in v.items()}
                for k, v in weights.items()}, path)
    return path


def program_args(flags: list):
    """The program's flags: its own parser's defaults, then `flags`."""
    from mvsnerf_tpu_torch.config import config_parser
    return config_parser([str(f) for f in flags])


# ----------------------------------------------------------------- spans ---

class Spans:
    """Named spans around calls into the program's layers. Off, they cost
    nothing; on (a traced run), each is a `record_function` range in the
    profiler's trace, which also marks its range on the device. None
    synchronises."""

    def __init__(self, on: bool):
        self.on = on

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        with torch.profiler.record_function("bench." + name):
            yield


# ------------------------------------------------------ launch counters ---

def launch_counts() -> dict:
    """The program's kernel launch counters, by kernel."""
    from mvsnerf_tpu_torch.ops import (color_warp, costreg_conv, mlp_train,
                                       render_fused, sweep, volume_gather)
    out = {
        "k1": sweep.sweep_cost_volume.launches,
        "k2": sweep.sweep_cost_volume.bwd_launches,
        "k4": color_warp.color_warp.launches,
        "k4_bwd": color_warp.color_warp.bwd_launches,
        "k5": volume_gather.sample_volume.launches,
        "k5_bwd": volume_gather.sample_volume.bwd_launches,
        "k6": render_fused.render_v0.launches,
        "k6b": render_fused.render_v0.baked_launches,
        "k7": mlp_train.mlp_v0_train.launches,
        "k7_bwd": mlp_train.mlp_v0_train.bwd_launches,
        "k8": render_fused.render_v0_feats.launches,
    }
    out.update({f"k10_{k}": v for k, v in costreg_conv.launches.items()})
    return out


# ----------------------------------------------------------------- trace ---

class Trace:
    """What a `torch.profiler` trace of the window says: device operations
    by name (count, seconds), the device's busy seconds (the union of its
    operations' intervals), and the longest idle gaps, each named by the
    innermost `bench.` span the host was in when the device went idle."""

    def __init__(self, prof):
        self.prof = prof
        evs = prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        # the host's ranges (`record_function`s, the optimizer's step) are
        # mirrored on the device's timeline; they are not device work
        host_names = {e.name() for e in evs if e.device_type() != cuda}
        dev, spans = [], []
        # a `bench.` span's range on the device: from the first to the end
        # of the last operation launched inside it
        self.device_spans = {}
        for e in evs:
            start, dur = _ns(e, "start"), _ns(e, "duration")
            if e.device_type() == cuda:
                if e.name().startswith("bench."):
                    self.device_spans.setdefault(e.name()[6:], []).append(
                        dur * 1e-9)
                elif e.name() not in host_names and not getattr(
                        e, "is_user_annotation", lambda: False)():
                    dev.append((start, start + dur, e.name()))
            elif e.name().startswith("bench."):
                spans.append((start, start + dur, e.name()[6:]))
        self.ops = {}
        for s, t, name in dev:
            c, sec = self.ops.get(name, (0, 0.0))
            self.ops[name] = (c + 1, sec + (t - s) * 1e-9)
        merged = []
        for s, t, _ in sorted(dev):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.busy_s = sum(t - s for s, t in merged) * 1e-9
        gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1])
                for i in range(len(merged) - 1)]
        gaps.sort(reverse=True)
        self.gaps = []
        for length, at in gaps[:10]:
            inside = [(t - s, name) for s, t, name in spans if s <= at <= t]
            self.gaps.append([min(inside)[1] if inside else "outside spans",
                              length * 1e-9])

    def span_ms(self, name: str):
        """Mean device ms of the `bench.<name>` span's ranges."""
        vals = self.device_spans.get(name)
        return 1e3 * float(np.mean(vals)) if vals else None

    def kernel(self, pattern: str):
        """(launches, seconds) of the device operations whose name matches
        the regular expression."""
        rx = re.compile(pattern)
        hits = [v for k, v in self.ops.items() if rx.search(k)]
        return sum(c for c, _ in hits), sum(s for _, s in hits)

    def op_device_s(self, names, ndim: int):
        """Device seconds of the kernels launched by the host operations
        named `names` whose first input has `ndim` dimensions (the trace
        records shapes)."""
        total, found = 0.0, False
        for e in self.prof.events():
            if e.name in names and e.input_shapes and \
                    len(e.input_shapes[0]) == ndim:
                found = True
                total += (e.device_time_total if hasattr(
                    e, "device_time_total") else e.cuda_time_total) * 1e-6
        return total if found else None

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:10]
        return {"device_ops": [[k[:200], v[1]] for k, v in top],
                "idle_gaps": self.gaps}


def _ns(event, what: str) -> int:
    """An event's start or duration in ns across profiler versions."""
    if hasattr(event, f"{what}_ns"):
        return int(getattr(event, f"{what}_ns")())
    return int(getattr(event, f"{what}_us")() * 1000)


# ------------------------------------------------------------- compare ---

def moved(grads: dict) -> set:
    """The leaves whose reference gradient is at least a thousandth of
    the median leaf's: the others move under Adam by round-off alone."""
    med = float(np.median(list(grads.values())))
    return {k for k, g in grads.items() if g >= 1e-3 * med}


def norm_gap(program: dict, reference: dict, leaves) -> float:
    """The worst of `leaves`' gaps of norms: |norm_p - norm_r| over the
    larger of the reference's norm of that leaf and its median leaf's."""
    med = float(np.median([reference[k] for k in leaves]))
    return max(abs(program[k] - reference[k]) / max(reference[k], med)
               for k in leaves)


def total_gap(program: dict, reference: dict, leaves) -> float:
    """The gap of the norm over all `leaves` together, relative to the
    reference's (a look beside the compared worst leaf, not compared)."""
    p = math.sqrt(sum(program[k] ** 2 for k in leaves))
    r = math.sqrt(sum(reference[k] ** 2 for k in leaves))
    return abs(p - r) / r


def leaf_gaps(program: dict, reference: dict, leaves, n: int = 5) -> list:
    """The n worst leaves: [name, program norm, reference norm]."""
    med = float(np.median([reference[k] for k in leaves]))
    worst = sorted(leaves, key=lambda k: -abs(program[k] - reference[k])
                   / max(reference[k], med))
    return [[k, program[k], reference[k]] for k in worst[:n]]

"""Tracing and throughput (counterpart of mvsnerf_tpu/utils/profiling.py):
named regions and whole traces on `torch.profiler`, anomaly detection for
NaN hunts, and a units-per-second meter.

`enable_compilation_cache` has no counterpart: it points XLA's persistent
compilation cache at a directory, and the port compiles no XLA programs
(its kernels are built once into mvsnerf_tpu_torch/_build/).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace_context(name: str):
    """Name a region in `torch.profiler`'s trace (JAX: a
    `jax.profiler.TraceAnnotation`)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Profile the body (the CPU, and the card when there is one) and write
    the Chrome trace `trace_<pid>_<ms>.json` into `log_dir`, viewable in
    Perfetto or chrome://tracing (JAX: `jax.profiler.start_trace`). Yields
    the profiler, whose `trace_path` is set once the body ends."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            prof.trace_path = os.path.join(
                log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}"
                ".json")
    prof.export_chrome_trace(prof.trace_path)


def enable_nan_debugging(enable: bool = True):
    """Raise at the backward op that makes a NaN: PyTorch's anomaly mode,
    the reference's global `set_detect_anomaly(True)` (models.py:2), here
    opt-in (JAX: `jax_debug_nans`)."""
    torch.autograd.set_detect_anomaly(enable)


class ThroughputMeter:
    """Units (rays, samples) per second on the host's clock, the first
    `skip` steps left out as warm-up (JAX's semantics). With a CUDA
    `device` the clock is read after synchronising it, so that queued
    kernels count."""

    def __init__(self, skip: int = 2, device=None):
        self.skip = skip
        self.device = None if device is None else torch.device(device)
        self._n = 0
        self._units = 0.0
        self._t0 = None

    def _now(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def step(self, units: float):
        self._n += 1
        if self._n == self.skip:
            self._t0 = self._now()
            self._units = 0.0
        elif self._n > self.skip:
            self._units += units

    @property
    def rate(self) -> float:
        if self._t0 is None or self._units == 0:
            return 0.0
        return self._units / (self._now() - self._t0)

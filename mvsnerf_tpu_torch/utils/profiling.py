"""Tracing (counterpart of mvsnerf_tpu/utils/profiling.py): the program's
named spans and whole traces on `torch.profiler`, and anomaly detection for
NaN hunts.

`enable_compilation_cache` has no counterpart: it points XLA's persistent
compilation cache at a directory, and the port compiles no XLA programs
(its kernels are built once into mvsnerf_tpu_torch/_build/).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


# a span when no profiler records: nothing entered
_OFF = contextlib.nullcontext()


def trace_context(name: str):
    """The program's span `mvsnerf.<name>`: a range in `torch.profiler`'s
    trace on the profiler's clock, entered only while a profiler records
    (JAX: a `jax.profiler.TraceAnnotation`); otherwise it costs one check.
    Nesting on the host gives each span its parent. A span reads no tensor
    and never synchronises.

    The range is a `RecordFunctionFast`, not a user annotation
    (`record_function`): the profiler mirrors a kernel onto the device
    timeline only under the innermost user annotation, so a span of that
    kind would take the device range away from any annotation a caller
    wraps around the program. A span's device work is found through the
    launches made inside it (the trace's correlation ids)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast("mvsnerf." + name)


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

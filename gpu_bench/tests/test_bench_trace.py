"""The reading of a profiler trace, on a made-up trace: busy seconds as
the union of device intervals, host ranges mirrored on the device left
out, idle gaps named by the host's innermost span, and the per-layer
readers' arithmetic."""

import torch

import toy  # noqa: F401
from gpu_bench import core, readers
from gpu_bench.costs import bound_s, mlp_v0

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MS = 1_000_000


class Ev:
    def __init__(self, name, dev, start_ms, dur_ms):
        self._n, self._d = name, dev
        self._s, self._t = int(start_ms * MS), int(dur_ms * MS)

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type(
            "R", (), {"events": lambda _self: events})()

    def events(self):
        """The host operations with their shapes: none on cuDNN here."""
        return []


K8 = "void render_v0_kernel<0, 20, true>(float const*)"


def trace():
    return core.Trace(Prof([
        Ev("bench.request", CPU, 0, 100), Ev("bench.render", CPU, 10, 55),
        Ev("bench.render", CUDA, 10, 55),          # a mirrored host range
        Ev(K8, CUDA, 10, 20), Ev(K8, CUDA, 25, 20),  # overlapping
        Ev("gemm", CUDA, 60, 10), Ev("memcpy", CUDA, 95, 2),
    ]))


def test_busy_is_the_union_of_device_intervals():
    tr = trace()
    assert abs(tr.busy_s - 0.047) < 1e-12     # 10-45, 60-70, 95-97 ms
    assert "bench.render" not in tr.ops
    assert tr.kernel(readers.K8) == (2, 0.04)


def test_idle_gaps_are_named_by_the_innermost_span():
    gaps = trace().gaps
    # 70-95 ms after the render span closed, 45-60 ms inside it
    assert gaps[0][0] == "request" and abs(gaps[0][1] - 0.025) < 1e-12
    assert gaps[1][0] == "render" and abs(gaps[1][1] - 0.015) < 1e-12
    assert len(trace().breakdown()["device_ops"]) == 3


def test_readers():
    tr = trace()
    ctx = {"trace": tr, "window_s": 0.1, "launches": {"k8": 4},
           "stats": {"rendered_rays": 1000}, "work_flops": 1.65e12,
           "config": {"samples_per_ray": 128}}
    assert abs(readers.idle_share(ctx) - 53.0) < 1e-9
    assert abs(readers.mfu(ctx) - 10.0) < 1e-9
    # 4 launches at the traced mean of 20 ms each
    want = 100 * bound_s(mlp_v0.render_flops(128000),
                         mlp_v0.render_bytes(1000, 128)) / 0.08
    assert abs(readers.k8_roofline(ctx) - want) < 1e-9
    assert readers.k8_roofline(dict(ctx, launches={"k8": 0})) is None
    assert readers.idle_share(dict(ctx, trace=None)) is None


def test_conv3d_reader_sees_k10_when_costreg_runs_on_it():
    """With `--costreg_impl dband` no cuDNN 3-D convolution is left: the
    reader reads K10's kernels, each at its traced mean a launch times the
    program's count of the call that launches it."""
    tr = core.Trace(Prof([
        Ev("void conv3d_pack_kernel(float const*)", CUDA, 0, 1),
        Ev("void conv3d_s1_tc_kernel<2, true>(float const*)", CUDA, 2, 8),
        Ev("void conv3d_s2_pair_kernel<8>(float const*)", CUDA, 11, 2),
        Ev("void conv3d_up_cell_kernel(float const*)", CUDA, 14, 3),
        Ev("void conv3d_wgrad_tc_kernel<1, 2>(float const*)", CUDA, 18, 10),
        Ev("void wgrad_reduce_kernel(float const*)", CUDA, 29, 1),
    ]))
    ctx = {"trace": tr, "stats": {"steps": 2},
           "launches": {"k10_s1": 2, "k10_s2": 1, "k10_up": 1,
                        "k10_wgrad": 3}}
    # s1: (1 + 8) x 2, s2: 2, up: 3, wgrad: (10 + 1) x 3 -> 56 ms, 2 steps
    assert abs(readers.conv3d_device_ms(ctx) - 28.0) < 1e-9
    no_k10 = dict(ctx, launches={k: 0 for k in ctx["launches"]})
    assert readers.conv3d_device_ms(no_k10) is None

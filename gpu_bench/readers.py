"""The arithmetic of the per-layer metrics, shared by the small readers
under `metrics/`. Each takes the run's context (`run.run_cell`) and
returns a number, or None when it finds nothing to read: a share of a
roofline or of the peak is never made up as 0."""

from __future__ import annotations

from .costs import PEAKS, bound_s, mlp_v0

# the render body K8 (`render_v0_feats`: PE, MLP, compositing of gathered
# features) by its name on the card
K8 = r"render_v0_kernel<0, ?20\b"


def idle_share(ctx):
    """Per cent of the traced window in which no operation ran on the
    device."""
    tr = ctx["trace"]
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / ctx["window_s"])


def mfu(ctx):
    """Per cent of the f32-equivalent peak: the model operations of all
    work completed in the traced window over its seconds."""
    if ctx["trace"] is None or not ctx["work_flops"]:
        return None
    return 100.0 * ctx["work_flops"] / ctx["window_s"] / PEAKS["flops_f32"]


def _device_s(ctx, patterns, launches):
    """Seconds of the window's launches of a kernel: its mean traced time
    a launch (the profiler can drop a launch) times the launches the
    program counted."""
    total = 0.0
    for pat in patterns:
        n, sec = ctx["trace"].kernel(pat)
        if not n:
            return None
        total += sec / n * launches
    return total


def k8_roofline(ctx):
    """Per cent: K8's bound for the rays it rendered over its device time."""
    launches = ctx["launches"]["k8"]
    rays = ctx["stats"].get("rendered_rays")
    if ctx["trace"] is None or not launches or not rays:
        return None
    t = _device_s(ctx, (K8,), launches)
    if not t:
        return None
    s = ctx["config"]["samples_per_ray"]
    return 100.0 * bound_s(mlp_v0.render_flops(rays * s),
                           mlp_v0.render_bytes(rays, s)) / t


# CostRegNet's 3-D convolutions on cuDNN: the host operations that launch
# them, forward and backward
CONV_OPS = ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
            "aten::convolution_backward")
# and on K10 (`--costreg_impl dband`, ops/costreg_conv.py): each kernel by
# its name on the card, with the launch counter of the call that launches
# it once
K10 = ((r"\bconv3d_pack_kernel\b", "k10_s1"),
       (r"\bconv3d_s1_tc_kernel\b", "k10_s1"),
       (r"\bconv3d_s2_pair_kernel\b|\bconv3d_fwd_kernel\b", "k10_s2"),
       (r"\bconv3d_up_cell_kernel\b", "k10_up"),
       (r"\bconv3d_wgrad_tc_kernel\b", "k10_wgrad"),
       (r"\bwgrad_reduce_kernel\b", "k10_wgrad"))


def conv3d_device_ms(ctx):
    """Device ms a step of CostRegNet's 3-D convolutions, forward and
    backward, on whichever route the program took: the kernels that
    cuDNN's host operations launched on 5-D inputs, plus K10's kernels
    (their traced mean a launch times the program's launches)."""
    steps = ctx["stats"].get("steps")
    if ctx["trace"] is None or not steps:
        return None
    parts = [ctx["trace"].op_device_s(CONV_OPS, 5)]
    for pattern, counter in K10:
        if ctx["launches"].get(counter):
            parts.append(_device_s(ctx, (pattern,), ctx["launches"][counter]))
    found = [p for p in parts if p]
    return 1e3 * sum(found) / steps if found else None

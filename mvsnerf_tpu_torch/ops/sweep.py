"""K1: the fused plane sweep + variance cost volume; K2, its backward; and
their plain twins.

`sweep_cost_volume` is, for CUDA tensors, a `torch.autograd.Function`
over csrc/sweep.cu: K1 forward, K2 backward (the gradient of every
channel of every source view, the reference view's included). For CPU
tensors it runs the plain PyTorch twin `sweep_cost_volume_plain` under
plain autograd; any other device raises. Both return the (1, 3V+C, D, hp,
wp) cost volume contiguous (NCDHW), channels [ref RGB, src RGB x (V-1),
variance(C)]: the layout cuDNN runs the f32 3-D U-Net in, so CostRegNet's
first conv3d reads it without a relayout. This store is the port of the
TPU relayout kernel K3 (`pack16_from_tiles`, pallas_sweep2.py:418): the
sweep writes the U-Net's layout itself, and K2 reads the cotangent
through its strides in whatever layout the U-Net's backward leaves
(NCDHW on the training path), so K3's cotangent direction
(`unpack16_to_tiles`, pallas_sweep2.py:487) needs no pass of its own.

K1 replaces mvsnerf_tpu/ops/pallas_sweep2.py:316 `cost_volume_xband_pallas`
and its fallback pallas_sweep.py:504 `cost_volume_fused_pallas`; K2 their
backward kernels (`_xb_bwd_kernel` pallas_sweep2.py:210, `_fused_bwd_kernel`
pallas_sweep.py:432). What bounds them on the H100: the 4 B x (3V+C)
per-voxel output write (K1) and cotangent read (K2). K1 first lays the
sources out quad-planar (`pack_quads` is that layout), so that a tap reads
4 channels with one 16-byte load, then tiles the reference columns and
planes, one channel group a block (`SW_*` below mirror csrc/sweep.cu). K2
tiles them too, and adds each block's taps into windows of the source
images in shared memory (`BWD_*`; `bwd_window` is its window rule), then
once per pixel into device memory; a tap outside its window goes to
device memory directly.
"""

from __future__ import annotations

import math

import torch

from .._build import check, library, stream_of
from .interp import grid_sample_2d


def plane_sweep_pix_coords(proj_mat, depth_values, h: int, w: int,
                           pad: int = 0):
    """Source-PIXEL sweep coordinates (xs, ys), each (1, D*hp*wp), for a
    (3, 4) relative projection [R | T]: R @ [x - pad, y - pad, 1] + T / d,
    then the perspective divide (mvsnerf_tpu/ops/homography.py:53-80)."""
    hp, wp = h + 2 * pad, w + 2 * pad
    dev = proj_mat.device
    gy, gx = torch.meshgrid(
        torch.arange(hp, dtype=torch.float32, device=dev) - pad,
        torch.arange(wp, dtype=torch.float32, device=dev) - pad,
        indexing="ij")
    gx, gy = gx.reshape(-1), gy.reshape(-1)
    # R @ [x, y, 1] written out element-wise, in csrc/sweep.cu's order
    rot = torch.stack([proj_mat[i, 0] * gx + proj_mat[i, 1] * gy
                       + proj_mat[i, 2] for i in range(3)])  # (3, hp*wp)
    src = rot[None] + proj_mat[:, 3:][None] / depth_values[:, None, None]
    inv_z = 1.0 / src[:, 2]
    return ((src[:, 0] * inv_z).reshape(1, -1),
            (src[:, 1] * inv_z).reshape(1, -1))


def sweep_cost_volume_plain(srcs, proj_mats, depth_values, pad: int,
                            c_feat: int):
    """Plain PyTorch twin of K1: per-view `grid_sample` warps (zeros
    padding, align_corners=True) of the [feat | rgb] sources, the strict
    in-bounds count, and var = E[x^2] - E[x]^2 over the views that see
    each voxel. Same arguments and result as `sweep_cost_volume`.

    Divisions are by device tensors (a divide by a Python scalar becomes a
    reciprocal multiply on CUDA), so the kernel can reproduce the sample
    coordinates exactly."""
    V, h, w, _ = srcs.shape
    D = depth_values.shape[0]
    hp, wp = h + 2 * pad, w + 2 * pad
    C = c_feat
    half_w = torch.tensor((w - 1) / 2.0, device=srcs.device)
    half_h = torch.tensor((h - 1) / 2.0, device=srcs.device)
    ref = torch.nn.functional.pad(srcs[0], (0, 0, pad, pad, pad, pad))
    vsum = ref[None, ..., :C]
    vsq = vsum ** 2
    count = torch.ones((D, hp, wp), device=srcs.device)
    out = torch.empty((1, 3 * V + C, D, hp, wp), device=srcs.device)
    dense = out[0].permute(1, 2, 3, 0)                  # (D, hp, wp, 3V+C)
    dense[..., 0:3] = ref[None, ..., C:C + 3]
    for v in range(1, V):
        xs, ys = plane_sweep_pix_coords(proj_mats[v], depth_values, h, w,
                                        pad)
        grid = torch.stack([xs[0] / half_w - 1.0, ys[0] / half_h - 1.0],
                           dim=-1)
        warped = grid_sample_2d(srcs[v], grid.reshape(D, hp, wp, 2))
        vsum = vsum + warped[..., :C]
        vsq = vsq + warped[..., :C] ** 2
        dense[..., 3 * v:3 * v + 3] = warped[..., C:C + 3]
        inside = (xs > 0) & (xs < w - 1) & (ys > 0) & (ys < h - 1)
        count = count + inside.float().reshape(D, hp, wp)
    inv = (1.0 / count)[..., None]
    dense[..., 3 * V:] = vsq * inv - (vsum * inv) ** 2
    return out


def sweep_cost_volume_bwd_plain(g, srcs, proj_mats, depth_values, pad: int,
                                c_feat: int):
    """Plain twin of K2: autograd of `sweep_cost_volume_plain`, the
    (V, h, w, c_feat + 3) gradient of `srcs` for the cost cotangent `g`."""
    with torch.enable_grad():
        s = srcs.detach().requires_grad_()
        out = sweep_cost_volume_plain(s, proj_mats, depth_values, pad, c_feat)
        return torch.autograd.grad(out, s, g)[0]


# K1's tiling (csrc/sweep.cu): a block owns SW_TX reference columns of
# SW_TY rows over SW_RUN planes, for SW_CG feature channels (4 quads) or
# the 3 rgb channels; a packed source pixel is SW_QUADS float4s
SW_TX, SW_TY, SW_RUN, SW_CG, SW_QUADS = 32, 4, 16, 16, 9


def pack_quads(srcs):
    """K1's source layout: the (V, h, w, 35) sources as (V, SW_QUADS, h,
    w, 4), quad q of a pixel its channels 4 q .. 4 q + 3, the last quad
    [r, g, b, 0] (csrc/sweep.cu `sweep_pack_kernel`)."""
    V, h, w, cs = srcs.shape
    padded = torch.nn.functional.pad(srcs, (0, 4 * SW_QUADS - cs))
    return padded.reshape(V, h, w, SW_QUADS, 4).permute(0, 3, 1, 2, 4) \
        .contiguous()


# K2's tiling (csrc/sweep.cu): a block owns BWD_TX reference columns of
# BWD_TY rows, every BWD_YSTEP-th row, over BWD_RUN planes, for BWD_CG
# feature channels or the 3 rgb channels; a source view's window holds at
# most BWD_WIN pixels; at most BWD_MAX_SRC source views (V <= 5: the
# window step gives each view's 8 corner points a lane of one warp)
BWD_TX, BWD_TY, BWD_YSTEP, BWD_RUN, BWD_CG = 32, 8, 2, 16, 8
BWD_MAX_SRC, BWD_WIN = 4, 768
# floats a pixel of the kernel's padded source gradient (C + 3 = 35 -> 36)
BWD_GS = 36


def bwd_window(ix, iy, front, h, w, cap=BWD_WIN):
    """A block's window in one source view (csrc/sweep.cu, the kernel's
    window step): from the grid_sample coordinates `ix`, `iy` of the block's
    4 corner columns at the run's first and last plane and whether each lies
    in front of the camera, the box of their taps widened by one pixel,
    clipped to the h x w image and cut to `cap` pixels: (x0, y0, width,
    height), width 0 when a corner is behind the camera or not finite."""
    ix, iy = torch.as_tensor(ix), torch.as_tensor(iy)
    ok = bool(front.all()) and bool(torch.isfinite(ix).all()) and \
        bool(torch.isfinite(iy).all())
    lx = float(ix.clamp(-2.0, w + 1.0).min())
    hx = float(ix.clamp(-2.0, w + 1.0).max())
    ly = float(iy.clamp(-2.0, h + 1.0).min())
    hy = float(iy.clamp(-2.0, h + 1.0).max())
    x0 = max(0, math.floor(lx) - 1)
    y0 = max(0, math.floor(ly) - 1)
    bw = min(w - 1, math.floor(hx) + 2) - x0 + 1
    bh = min(h - 1, math.floor(hy) + 2) - y0 + 1
    if not ok or bw <= 0 or bh <= 0:
        return x0, y0, 0, 0
    if bw * bh > cap:
        bw, bh = (cap, 1) if bw > cap else (bw, cap // bw)
    return x0, y0, bw, bh


def _check_args(srcs, proj_mats, depth_values, pad, c_feat):
    V, h, w, cs = srcs.shape
    dev = srcs.device
    if dev.type != "cuda":
        raise ValueError(f"sweep kernel: tensors on {dev}, not a CUDA "
                         f"device")
    if c_feat != 32 or cs != c_feat + 3 or V < 2:
        raise ValueError(f"sweep kernel takes (V>=2, h, w, 35) sources with "
                         f"32 feature channels, got {tuple(srcs.shape)}, "
                         f"c_feat={c_feat}")
    if proj_mats.shape != (V, 3, 4) or depth_values.dim() != 1:
        raise ValueError(f"bad proj_mats {tuple(proj_mats.shape)} or "
                         f"depth_values {tuple(depth_values.shape)}")
    for name, t in (("srcs", srcs), ("proj_mats", proj_mats),
                    ("depth_values", depth_values)):
        if t.device != dev or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"sweep kernel: {name} must be contiguous "
                             f"float32 on {dev}")
    if pad < 0 or h < 2 or w < 2:
        raise ValueError(f"sweep kernel: bad pad {pad} or size {h}x{w}")


def sweep_cost_volume_kernel(srcs, proj_mats, depth_values, pad: int,
                             c_feat: int):
    """K1 on the card (no autograd): the cost volume of `sweep_cost_volume`.
    One call launches the sources' relayout (`pack_quads`, into a scratch
    tensor) and the sweep."""
    _check_args(srcs, proj_mats, depth_values, pad, c_feat)
    V, h, w, _ = srcs.shape
    D = depth_values.shape[0]
    out = torch.empty((1, 3 * V + c_feat, D, h + 2 * pad, w + 2 * pad),
                      device=srcs.device)
    packed = torch.empty((V, SW_QUADS, h, w, 4), device=srcs.device)
    srcp = proj_mats[1:].contiguous()
    rc = library().sweep_cost_volume(
        srcs.data_ptr(), packed.data_ptr(), srcp.data_ptr(),
        depth_values.data_ptr(), out.data_ptr(), V, h, w, c_feat, D, pad,
        stream_of(srcs))
    check(rc, "sweep_cost_volume")
    sweep_cost_volume.launches += 1
    return out


def sweep_cost_volume_bwd_kernel(g, srcs, proj_mats, depth_values, pad: int,
                                 c_feat: int, taps=None):
    """K2 on the card: the (V, h, w, c_feat + 3) gradient of `srcs` for the
    (1, 3V + c_feat, D, hp, wp) cost cotangent `g`, every channel of every
    view (a view of the kernel's gradient, padded to BWD_GS floats a
    pixel). K3's cotangent direction has no pass of its own: the kernel
    reads `g` through its strides, where the U-Net's backward leaves it
    (NCDHW, channels_last_3d, or expanded), without a copy. `taps`, when
    given, is a zeroed int64 CUDA tensor of 2 to which the kernel adds the
    feature taps it added into its windows and those it added in device
    memory instead."""
    if srcs.shape[0] > BWD_MAX_SRC + 1:
        raise ValueError(f"sweep backward kernel: {srcs.shape[0] - 1} source "
                         f"views, at most {BWD_MAX_SRC}")
    _check_args(srcs, proj_mats, depth_values, pad, c_feat)
    V, h, w, cs = srcs.shape
    D = depth_values.shape[0]
    shape = (1, 3 * V + c_feat, D, h + 2 * pad, w + 2 * pad)
    if tuple(g.shape) != shape or g.dtype != torch.float32 or \
            g.device != srcs.device:
        raise ValueError(f"sweep backward kernel: cotangent "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}, "
                         f"expected {shape} float32 on {srcs.device}")
    if taps is not None and (taps.shape != (2,) or
                             taps.dtype != torch.int64 or
                             taps.device != srcs.device):
        raise ValueError(f"sweep backward kernel: taps must be an int64 "
                         f"(2,) tensor on {srcs.device}")
    g_srcs = torch.zeros((V, h, w, BWD_GS), device=srcs.device)
    srcp = proj_mats[1:].contiguous()
    rc = library().sweep_cost_volume_bwd(
        g.data_ptr(), *g.stride()[1:], srcs.data_ptr(), srcp.data_ptr(),
        depth_values.data_ptr(), g_srcs.data_ptr(), V, h, w, c_feat, D, pad,
        None if taps is None else taps.data_ptr(), stream_of(srcs))
    check(rc, "sweep_cost_volume_bwd")
    sweep_cost_volume.bwd_launches += 1
    return g_srcs[..., :cs]


class _SweepCostVolume(torch.autograd.Function):
    """K1 forward, K2 backward. Saves only the sources, projections and
    depths: K2 recomputes the warps."""

    @staticmethod
    def forward(ctx, srcs, proj_mats, depth_values, pad, c_feat):
        ctx.save_for_backward(srcs, proj_mats, depth_values)
        ctx.pad, ctx.c_feat = pad, c_feat
        return sweep_cost_volume_kernel(srcs, proj_mats, depth_values, pad,
                                        c_feat)

    @staticmethod
    def backward(ctx, g):
        srcs, proj_mats, depth_values = ctx.saved_tensors
        g_srcs = None
        if ctx.needs_input_grad[0]:
            g_srcs = sweep_cost_volume_bwd_kernel(
                g, srcs, proj_mats, depth_values, ctx.pad, ctx.c_feat)
        # the sweep coordinates get no gradient, as in JAX
        return g_srcs, None, None, None, None


def sweep_cost_volume(srcs, proj_mats, depth_values, pad: int,
                      c_feat: int):
    """The cost volume from per-view [feat | rgb] sources, differentiable
    in `srcs`.

    Args:
        srcs: (V, h, w, c_feat + 3) float32 channel-last sources at feature
            resolution, view 0 = reference.
        proj_mats: (V, 3, 4) relative projections (row 0 unused).
        depth_values: (D,) sweep-plane depths.
        pad: symmetric feature-grid padding.
    Returns:
        (1, 3V + c_feat, D, hp, wp) float32, contiguous (NCDHW).
    """
    if srcs.device.type == "cpu":
        return sweep_cost_volume_plain(srcs, proj_mats, depth_values, pad,
                                       c_feat)
    if srcs.device.type != "cuda":
        raise ValueError(f"sweep_cost_volume: no kernel for {srcs.device}")
    return _SweepCostVolume.apply(srcs, proj_mats, depth_values, pad, c_feat)


sweep_cost_volume.launches = 0      # K1 forward launches
sweep_cost_volume.bwd_launches = 0  # K2 launches

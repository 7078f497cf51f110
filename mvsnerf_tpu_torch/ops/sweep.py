"""K1: the fused plane sweep + variance cost volume, and its plain twin.

`sweep_cost_volume` launches csrc/sweep.cu for CUDA tensors and runs the
plain PyTorch twin `sweep_cost_volume_plain` for CPU tensors; any other
device raises. Both return the (1, 3V+C, D, hp, wp) cost volume in
`torch.channels_last_3d` memory (physically (D, hp, wp, 3V+C)), channels
[ref RGB, src RGB x (V-1), variance(C)], which CostRegNet's first conv3d
reads without a copy. This output layout is the port of the TPU relayout
kernel K3 (`pack16_from_tiles`, pallas_sweep2.py:418): the sweep writes
the U-Net's layout itself.

Replaces mvsnerf_tpu/ops/pallas_sweep2.py:316 `cost_volume_xband_pallas`
and its fallback pallas_sweep.py:504 `cost_volume_fused_pallas`. What
bounds it on the H100: the 4 B x (3V+C) per-voxel output write.
"""

from __future__ import annotations

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
    out = torch.empty((1, 3 * V + C, D, hp, wp), device=srcs.device,
                      memory_format=torch.channels_last_3d)
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


def sweep_cost_volume(srcs, proj_mats, depth_values, pad: int,
                      c_feat: int):
    """The cost volume from per-view [feat | rgb] sources.

    Args:
        srcs: (V, h, w, c_feat + 3) float32 channel-last sources at feature
            resolution, view 0 = reference.
        proj_mats: (V, 3, 4) relative projections (row 0 unused).
        depth_values: (D,) sweep-plane depths.
        pad: symmetric feature-grid padding.
    Returns:
        (1, 3V + c_feat, D, hp, wp) float32, channels_last_3d.
    """
    if srcs.device.type == "cpu":
        return sweep_cost_volume_plain(srcs, proj_mats, depth_values, pad,
                                       c_feat)
    if srcs.device.type != "cuda":
        raise ValueError(f"sweep_cost_volume: no kernel for {srcs.device}")
    V, h, w, cs = srcs.shape
    D = depth_values.shape[0]
    dev = srcs.device
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
    hp, wp = h + 2 * pad, w + 2 * pad
    out = torch.empty((1, 3 * V + c_feat, D, hp, wp), device=dev,
                      memory_format=torch.channels_last_3d)
    srcp = proj_mats[1:].contiguous()
    rc = library().sweep_cost_volume(
        srcs.data_ptr(), srcp.data_ptr(), depth_values.data_ptr(),
        out.data_ptr(), V, h, w, c_feat, D, pad, stream_of(srcs))
    check(rc, "sweep_cost_volume")
    sweep_cost_volume.launches += 1
    return out


sweep_cost_volume.launches = 0

"""K4: per-sample source-view colours + masks, and the plain twin.

`color_warp` launches csrc/color_warp.cu for CUDA tensors and runs the
plain PyTorch twin `color_warp_plain` for CPU tensors; any other device
raises. Output (N, S, 4V) in per-view blocks [R, G, B, mask]: RGB by
bilinear border-padded sampling (align_corners=True) at the point's
projection into each view, mask = projection strictly inside the image.

Replaces mvsnerf_tpu/ops/pallas_sweep.py:258 `bilinear_warp_pallas`
(forward) as reached from render/renderer.py:77-106. What bounds it on the
H100: the 48 B-per-sample output write.
"""

from __future__ import annotations

import torch

from .._build import check, library, stream_of
from .interp import grid_sample_2d


def color_warp_plain(pts_world, w2cs, intrinsics, imgs):
    """Plain PyTorch twin of K4. The projection is written out
    element-wise (no matmul), in the order the kernel evaluates it, and
    divides by device tensors (a divide by a Python scalar becomes a
    reciprocal multiply on CUDA), so both see the same sample coordinates.
    """
    V, H, W, _ = imgs.shape
    px, py, pz = pts_world.unbind(-1)
    wm1 = torch.tensor(W - 1.0, device=imgs.device)
    hm1 = torch.tensor(H - 1.0, device=imgs.device)
    parts = []
    for v in range(V):
        E, K = w2cs[v], intrinsics[v]
        cam = [px * E[i, 0] + py * E[i, 1] + pz * E[i, 2] + E[i, 3]
               for i in range(3)]
        pix = [cam[0] * K[i, 0] + cam[1] * K[i, 1] + cam[2] * K[i, 2]
               for i in range(3)]
        gx = pix[0] / pix[2] / wm1 * 2.0 - 1.0
        gy = pix[1] / pix[2] / hm1 * 2.0 - 1.0
        rgb = grid_sample_2d(imgs[v], torch.stack([gx, gy], dim=-1),
                             padding_mode="border")
        inside = (gx > -1.0) & (gx < 1.0) & (gy > -1.0) & (gy < 1.0)
        parts += [rgb, inside.float()[..., None]]
    return torch.cat(parts, dim=-1)


def color_warp(pts_world, w2cs, intrinsics, imgs):
    """Per-sample colours and masks from V source views.

    Args:
        pts_world: (N, S, 3) float32 world points.
        w2cs: (V, 4, 4); intrinsics: (V, 3, 3); imgs: (V, H, W, 3).
    Returns:
        (N, S, 4V) float32.
    """
    if pts_world.device.type == "cpu":
        return color_warp_plain(pts_world, w2cs, intrinsics, imgs)
    if pts_world.device.type != "cuda":
        raise ValueError(f"color_warp: no kernel for {pts_world.device}")
    V, H, W, _ = imgs.shape
    dev = pts_world.device
    if pts_world.dim() != 3 or pts_world.shape[-1] != 3 or \
            w2cs.shape != (V, 4, 4) or intrinsics.shape != (V, 3, 3) or \
            imgs.shape[-1] != 3 or H < 2 or W < 2:
        raise ValueError(
            f"color_warp kernel: bad shapes pts {tuple(pts_world.shape)}, "
            f"w2cs {tuple(w2cs.shape)}, intrinsics "
            f"{tuple(intrinsics.shape)}, imgs {tuple(imgs.shape)}")
    for name, t in (("pts_world", pts_world), ("w2cs", w2cs),
                    ("intrinsics", intrinsics), ("imgs", imgs)):
        if t.device != dev or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"color_warp kernel: {name} must be contiguous "
                             f"float32 on {dev}")
    N, S, _ = pts_world.shape
    if N * S >= 2 ** 31:
        raise ValueError(f"color_warp kernel: {N * S} samples exceed int32")
    out = torch.empty((N, S, 4 * V), device=dev)
    rc = library().color_warp(
        pts_world.data_ptr(), w2cs.data_ptr(), intrinsics.data_ptr(),
        imgs.data_ptr(), out.data_ptr(), N * S, V, H, W,
        stream_of(pts_world))
    check(rc, "color_warp")
    color_warp.launches += 1
    return out


color_warp.launches = 0

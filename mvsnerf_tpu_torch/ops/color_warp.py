"""K4: per-sample source-view colours + masks, its transpose (the source
images' gradient), and the plain twins.

`color_warp` launches csrc/color_warp.cu for CUDA tensors and runs the
plain PyTorch twin `color_warp_plain` for CPU tensors; any other device
raises. Output (N, S, 4V) in per-view blocks [R, G, B, mask]: RGB by
bilinear border-padded sampling (align_corners=True) at the point's
projection into each view, mask = projection strictly inside the image.

The gradient contract: `color_warp` is differentiable in `imgs` only. On a
card, with grad mode on and `imgs.requires_grad`, it goes through the
autograd Function `_ColorWarp`, whose backward launches `color_warp_bwd`
(the RGB cotangent scattered into the (V, H, W, 3) image gradient at the
forward's taps; the mask's is dropped). Otherwise it is the bare forward
launch, with nothing saved. A gradient in `pts_world`, `w2cs` or
`intrinsics` is refused on every device: JAX's TPU route returns a silent
zero for it and nothing in the port trains the geometry. The twin
`color_warp_plain` stays differentiable in every input.

Replaces mvsnerf_tpu/ops/pallas_sweep.py:258 `bilinear_warp_pallas`
(forward) and :147 `_bwd_kernel` (its VJP, via `_warp_bwd_rule` :316) as
reached from render/renderer.py:77-106. What bounds it on the H100: the
forward's 48 B-per-sample output write; the backward's f32 atomics.
"""

from __future__ import annotations

import torch

from .._build import check, library, stream_of
from .interp import grid_sample_2d


def color_warp_grids(pts_world, w2cs, intrinsics, H: int, W: int):
    """The (V, N, S, 2) normalised sampling coordinates of K4: the
    projection written out element-wise (no matmul), in the order the
    kernel evaluates it, dividing by device tensors (a divide by a Python
    scalar becomes a reciprocal multiply on CUDA), so twin and kernel see
    the same sample coordinates."""
    px, py, pz = pts_world.unbind(-1)
    wm1 = torch.tensor(W - 1.0, device=pts_world.device)
    hm1 = torch.tensor(H - 1.0, device=pts_world.device)
    grids = []
    for v in range(w2cs.shape[0]):
        E, K = w2cs[v], intrinsics[v]
        cam = [px * E[i, 0] + py * E[i, 1] + pz * E[i, 2] + E[i, 3]
               for i in range(3)]
        pix = [cam[0] * K[i, 0] + cam[1] * K[i, 1] + cam[2] * K[i, 2]
               for i in range(3)]
        grids.append(torch.stack([pix[0] / pix[2] / wm1 * 2.0 - 1.0,
                                  pix[1] / pix[2] / hm1 * 2.0 - 1.0], -1))
    return torch.stack(grids)


def color_warp_plain(pts_world, w2cs, intrinsics, imgs):
    """Plain PyTorch twin of K4, differentiable in every input (its image
    gradient is `grid_sample`'s backward, the twin of `color_warp_bwd`)."""
    grids = color_warp_grids(pts_world, w2cs, intrinsics, *imgs.shape[1:3])
    parts = []
    for v, grid in enumerate(grids):
        rgb = grid_sample_2d(imgs[v], grid, padding_mode="border")
        inside = (grid > -1.0) & (grid < 1.0)
        parts += [rgb, (inside[..., 0] & inside[..., 1]).float()[..., None]]
    return torch.cat(parts, dim=-1)


def color_warp_bwd_plain(g, pts_world, w2cs, intrinsics, imgs):
    """Plain twin of K4's backward: the (V, H, W, 3) image gradient of
    the (N, S, 4V) cotangent `g`, by autograd of `color_warp_plain`."""
    with torch.enable_grad():
        im = imgs.detach().requires_grad_()
        out = color_warp_plain(pts_world.detach(), w2cs.detach(),
                               intrinsics.detach(), im)
        return torch.autograd.grad(out, im, g)[0]


def _check_args(pts_world, w2cs, intrinsics, imgs):
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


def color_warp_kernel(pts_world, w2cs, intrinsics, imgs):
    """K4 forward on the card: (N, S, 4V) colours and masks (no
    autograd)."""
    _check_args(pts_world, w2cs, intrinsics, imgs)
    V, H, W, _ = imgs.shape
    N, S, _ = pts_world.shape
    out = torch.empty((N, S, 4 * V), device=pts_world.device)
    rc = library().color_warp(
        pts_world.data_ptr(), w2cs.data_ptr(), intrinsics.data_ptr(),
        imgs.data_ptr(), out.data_ptr(), N * S, V, H, W,
        stream_of(pts_world))
    check(rc, "color_warp")
    color_warp.launches += 1
    return out


def color_warp_bwd_kernel(g, pts_world, w2cs, intrinsics, img_shape):
    """K4 backward on the card: the `img_shape` (V, H, W, 3) image
    gradient of the (N, S, 4V) cotangent `g`, zeroed then scattered into
    with atomics."""
    gimgs = torch.zeros(img_shape, device=g.device)
    _check_args(pts_world, w2cs, intrinsics, gimgs)
    V, H, W, _ = img_shape
    N, S, _ = pts_world.shape
    if g.shape != (N, S, 4 * V) or g.dtype != torch.float32 or \
            g.device != gimgs.device or not g.is_contiguous():
        raise ValueError(f"color_warp_bwd kernel: bad cotangent "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    rc = library().color_warp_bwd(
        g.data_ptr(), pts_world.data_ptr(), w2cs.data_ptr(),
        intrinsics.data_ptr(), gimgs.data_ptr(), N * S, V, H, W,
        stream_of(g))
    check(rc, "color_warp_bwd")
    color_warp.bwd_launches += 1
    return gimgs


class _ColorWarp(torch.autograd.Function):

    @staticmethod
    def forward(ctx, pts_world, w2cs, intrinsics, imgs):
        ctx.save_for_backward(pts_world, w2cs, intrinsics)
        ctx.img_shape = imgs.shape
        return color_warp_kernel(pts_world, w2cs, intrinsics, imgs)

    @staticmethod
    def backward(ctx, g):
        pts_world, w2cs, intrinsics = ctx.saved_tensors
        return None, None, None, color_warp_bwd_kernel(
            g.contiguous(), pts_world, w2cs, intrinsics, ctx.img_shape)


def color_warp(pts_world, w2cs, intrinsics, imgs):
    """Per-sample colours and masks from V source views, differentiable in
    `imgs` only.

    Args:
        pts_world: (N, S, 3) float32 world points.
        w2cs: (V, 4, 4); intrinsics: (V, 3, 3); imgs: (V, H, W, 3).
    Returns:
        (N, S, 4V) float32.
    """
    if torch.is_grad_enabled():
        wanted = [name for name, t in (("pts_world", pts_world),
                                       ("w2cs", w2cs),
                                       ("intrinsics", intrinsics))
                  if t.requires_grad]
        if wanted:
            raise NotImplementedError(
                f"color_warp: no gradient in {', '.join(wanted)} (only imgs "
                "is differentiable; detach the geometry)")
    if pts_world.device.type == "cpu":
        return color_warp_plain(pts_world, w2cs, intrinsics, imgs)
    if pts_world.device.type != "cuda":
        raise ValueError(f"color_warp: no kernel for {pts_world.device}")
    if torch.is_grad_enabled() and imgs.requires_grad:
        return _ColorWarp.apply(pts_world, w2cs, intrinsics, imgs)
    return color_warp_kernel(pts_world, w2cs, intrinsics, imgs)


color_warp.launches = 0      # forward kernels
color_warp.bwd_launches = 0  # backward kernels

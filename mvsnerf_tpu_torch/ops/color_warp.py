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
reached from render/renderer.py:77-106. Both kernels run one thread per
(sample, view) pair, so each thread stores (or, backward, loads) one
aligned 16-byte [R, G, B, mask] slot and a warp's access is contiguous.
What bounds them on the H100: the forward, its 16 B per sample and view of
output write and the projection's IEEE divides; the backward, its atomics
into the image gradient. Lanes of a warp with the same tap base first sum
their products with shuffles, and one lane adds each tap's three channels
with one float4 atomic into an RGBA-padded gradient, which the C call
zeroes on the same stream; the wrapper returns a (V, H, W, 3) view of its
RGB. On a card the wrappers' host time (the checks, the allocation, the
ctypes call) exceeds the forward's device time at the fine-tune batch.
"""

from __future__ import annotations

import torch

from .._build import check, library, stream_of
from .interp import grid_sample_2d

_F32 = torch.float32
MAX_VIEWS = 256  # the kernels' block of 256 threads holds >= 1 sample


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


def _check_args(pts_world, w2cs, intrinsics, imgs, g=None):
    """Refuse (ValueError) what K4's kernels cannot take: shapes other than
    pts_world (N, S, 3), w2cs (V, 4, 4), intrinsics (V, 3, 3) and imgs
    (V, H, W, 3) with H, W >= 2 (for the backward, whose cotangent is `g`,
    imgs is its (V, H, W, 4) RGBA-padded gradient); a tensor that is not
    contiguous float32 on pts_world's device; N * S >= 2**31 samples; more
    than 256 views; a cotangent other than a contiguous, 16-byte aligned
    float32 (N, S, 4V) on that device; a device other than CUDA. Returns
    (N, S, V, H, W)."""
    ps, ims = pts_world.shape, imgs.shape
    if len(ps) != 3 or len(ims) != 4 or ps[2] != 3 or \
            ims[3] != (3 if g is None else 4) or ims[1] < 2 or \
            ims[2] < 2 or w2cs.shape != (ims[0], 4, 4) or \
            intrinsics.shape != (ims[0], 3, 3):
        raise ValueError(
            f"color_warp kernel: bad shapes pts {tuple(pts_world.shape)}, "
            f"w2cs {tuple(w2cs.shape)}, intrinsics "
            f"{tuple(intrinsics.shape)}, imgs {tuple(imgs.shape)}")
    dev = pts_world.device
    if not (pts_world.dtype is _F32 and w2cs.dtype is _F32 and
            intrinsics.dtype is _F32 and imgs.dtype is _F32 and
            w2cs.device == dev and intrinsics.device == dev and
            imgs.device == dev and pts_world.is_contiguous() and
            w2cs.is_contiguous() and intrinsics.is_contiguous() and
            imgs.is_contiguous()):
        for name, t in (("pts_world", pts_world), ("w2cs", w2cs),
                        ("intrinsics", intrinsics), ("imgs", imgs)):
            if t.device != dev or t.dtype is not _F32 or \
                    not t.is_contiguous():
                raise ValueError(f"color_warp kernel: {name} must be "
                                 f"contiguous float32 on {dev}")
    N, S, _ = ps
    V, H, W, _ = ims
    if N * S >= 2 ** 31:
        raise ValueError(f"color_warp kernel: {N * S} samples exceed int32")
    if V > MAX_VIEWS:
        raise ValueError(f"color_warp kernel: {V} views exceed {MAX_VIEWS}")
    if g is not None and (g.shape != (N, S, 4 * V) or g.dtype is not _F32
                          or g.device != dev or not g.is_contiguous() or
                          g.data_ptr() % 16):
        raise ValueError(f"color_warp_bwd kernel: bad cotangent "
                         f"{tuple(g.shape)} {g.dtype} on {g.device} (must "
                         f"be contiguous, 16-byte aligned float32 "
                         f"{(N, S, 4 * V)} on {dev})")
    if dev.type != "cuda":
        raise ValueError(f"color_warp kernel: tensors on {dev}, not CUDA")
    return N, S, V, H, W


def color_warp_kernel(pts_world, w2cs, intrinsics, imgs):
    """K4 forward on the card: (N, S, 4V) colours and masks (no
    autograd)."""
    N, S, V, H, W = _check_args(pts_world, w2cs, intrinsics, imgs)
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
    gradient of the (N, S, 4V) cotangent `g` (contiguous, 16-byte
    aligned), zeroed and scattered into by one C call. The kernel adds a
    tap's three channels with one float4 atomic, so the gradient is made
    RGBA-padded and returned as a (V, H, W, 3) view of its RGB."""
    if len(img_shape) != 4 or img_shape[3] != 3:
        raise ValueError(f"color_warp_bwd kernel: bad image shape "
                         f"{tuple(img_shape)}")
    gimgs = torch.empty((*img_shape[:3], 4), device=pts_world.device)
    N, S, V, H, W = _check_args(pts_world, w2cs, intrinsics, gimgs, g)
    rc = library().color_warp_bwd(
        g.data_ptr(), pts_world.data_ptr(), w2cs.data_ptr(),
        intrinsics.data_ptr(), gimgs.data_ptr(), N * S, V, H, W,
        stream_of(g))
    check(rc, "color_warp_bwd")
    color_warp.bwd_launches += 1
    return gimgs[..., :3]


class _ColorWarp(torch.autograd.Function):

    @staticmethod
    def forward(ctx, pts_world, w2cs, intrinsics, imgs):
        ctx.save_for_backward(pts_world, w2cs, intrinsics)
        ctx.img_shape = imgs.shape
        return color_warp_kernel(pts_world, w2cs, intrinsics, imgs)

    @staticmethod
    def backward(ctx, g):
        pts_world, w2cs, intrinsics = ctx.saved_tensors
        g = g.contiguous()
        if g.data_ptr() % 16:  # a view into a larger buffer
            g = g.clone()
        return None, None, None, color_warp_bwd_kernel(
            g, pts_world, w2cs, intrinsics, ctx.img_shape)


def color_warp(pts_world, w2cs, intrinsics, imgs):
    """Per-sample colours and masks from V source views, differentiable in
    `imgs` only.

    Args:
        pts_world: (N, S, 3) float32 world points.
        w2cs: (V, 4, 4); intrinsics: (V, 3, 3); imgs: (V, H, W, 3).
    Returns:
        (N, S, 4V) float32.
    """
    if torch.is_grad_enabled() and (pts_world.requires_grad or
                                    w2cs.requires_grad or
                                    intrinsics.requires_grad):
        wanted = [name for name, t in (("pts_world", pts_world),
                                       ("w2cs", w2cs),
                                       ("intrinsics", intrinsics))
                  if t.requires_grad]
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

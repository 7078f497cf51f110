"""K5: the trainable-volume gather (forward) and splat (backward), and the
plain twin.

`sample_volume(volume, ndc)` is a trilinear, zeros-padded,
align_corners=True fetch of a (D, hp, wp, C) float32 volume at (N, S, 3)
NDC in [0, 1] ordered (x, y, z), returning (N, S, C): the function of
`index_point_feature`, differentiable with respect to the volume. For CUDA
tensors it is a `torch.autograd.Function` over csrc/volume_gather.cu:
the forward gathers, the backward zeroes a dense volume gradient and
splats the cotangent into it with atomics. The NDC gradient, when asked
for, is the plain grid_sample VJP, as the JAX kernel computes it
(mvsnerf_tpu/ops/pallas_volgather2.py:338-341). For CPU tensors it runs
the plain twin `sample_volume_plain`; any other device raises.

Replaces mvsnerf_tpu/ops/pallas_volgather2.py:268 `sample_volume_pallas2`
(via `sample_volume_sorted`, render/renderer.py:187-193) and the role of
the banded XLA VJP `sample_volume_train`. What bounds it on the H100: the
forward reads 8 corners x 32 B per sample and writes 32 B; the backward
zeroes the 150 MB volume gradient and adds each corner's 4 channels with
one 16-byte atomic, merging a sample's upper corners into the next
sample's lower ones where they coincide (`splat_merges` is the rule).
"""

from __future__ import annotations

import torch

from .._build import check, library, stream_of
from .interp import grid_sample_3d, index_point_feature


def sample_volume_plain(volume, ndc):
    """Plain twin of K5: `index_point_feature` under autograd."""
    return index_point_feature(volume, ndc)


def _check_args(volume, ndc):
    if volume.dim() != 4 or ndc.dim() != 3 or ndc.shape[-1] != 3:
        raise ValueError(f"volume gather kernel: bad shapes volume "
                         f"{tuple(volume.shape)}, ndc {tuple(ndc.shape)}")
    D, hp, wp, C = volume.shape
    if C % 4 or min(D, hp, wp) < 1:
        raise ValueError(f"volume gather kernel: needs C % 4 == 0, got "
                         f"volume {tuple(volume.shape)}")
    for name, t in (("volume", volume), ("ndc", ndc)):
        if t.device != volume.device or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"volume gather kernel: {name} must be "
                             f"contiguous float32 on {volume.device}")
    if ndc.shape[0] * ndc.shape[1] * (C // 4) >= 2 ** 31 or \
            volume.numel() >= 2 ** 31:
        raise ValueError("volume gather kernel: sizes exceed int32")


def volume_gather_kernel(volume, ndc):
    """K5 forward on the card: (N, S, C) features (no autograd)."""
    _check_args(volume, ndc)
    D, hp, wp, C = volume.shape
    N, S, _ = ndc.shape
    out = torch.empty((N, S, C), device=volume.device)
    rc = library().volume_gather_fwd(
        volume.data_ptr(), ndc.data_ptr(), out.data_ptr(), N * S, D, hp, wp,
        C, stream_of(volume))
    check(rc, "volume_gather_fwd")
    sample_volume.launches += 1
    return out


# threads of a warp: the splat's merges stay inside one
WARP = 32


def splat_merges(ndc, volume_shape):
    """The splat's merge rule (csrc/volume_gather.cu `splat_kernel`), on
    any device: thread i = s * CG + j (CG = C / 4) holds sample s's channels
    4 j .. 4 j + 3. It takes the upper 4 corners of the thread CG lanes
    before it in its warp of WARP threads (sample s - 1) into its lower 4
    when both samples have a corner in the volume, the same x and y taps
    and z taps one plane apart. Returns `take`, (N * S, CG) bool: thread
    (s, j) takes sample s - 1's upper corners; and the counts the kernel's
    `adds` reports, (corner adds to device memory, corner adds merged)."""
    D, hp, wp, C = volume_shape
    cg = C // 4
    p = ndc.reshape(-1, 3)
    size = torch.tensor([wp, hp, D], device=p.device)
    # grid_sample(align_corners=True)'s coordinate, in the kernel's order
    ix = (p * 2.0 - 1.0 + 1.0) / 2.0 * (size - 1)
    on = ((ix > -1) & (ix < size)).all(-1)
    base = ix.floor().long()
    corners = [base + torch.tensor([k & 1, k >> 1 & 1, k >> 2],
                                   device=p.device) for k in range(8)]
    inside = torch.stack([((c >= 0) & (c < size)).all(-1) & on
                          for c in corners], -1)          # (N * S, 8)
    same = on[1:] & on[:-1] & (base[1:, :2] == base[:-1, :2]).all(-1) & \
        (base[1:, 2] == base[:-1, 2] + 1)
    lane = (torch.arange(len(p), device=p.device)[:, None] * cg +
            torch.arange(cg, device=p.device)) % WARP       # (N * S, CG)
    take = torch.zeros((len(p), cg), dtype=torch.bool, device=p.device)
    take[1:] = same[:, None] & (lane[1:] >= cg)
    upper = inside[:, 4:].sum(-1)                           # per sample
    merged = int((take[1:] * upper[:-1, None]).sum())
    return take, (int(inside.sum()) * cg - merged, merged)


def volume_splat_kernel(g, ndc, volume_shape, adds=None, out=None):
    """K5 backward on the card: the (D, hp, wp, C) volume gradient of the
    (N, S, C) cotangent `g`, zeroed then splatted with 16-byte atomics.
    `adds`, when given, is a zeroed int64 CUDA tensor of 2 to which the
    kernel adds its corner adds to device memory and those it merged into
    the next sample's (`splat_merges`). `out`, when given, is a
    `volume_shape` tensor that the splat adds into as it stands (not
    zeroed) and returns: the fusion trainer's accumulator."""
    D, hp, wp, C = volume_shape
    gvol = torch.zeros(volume_shape, device=g.device) if out is None else out
    if tuple(gvol.shape) != tuple(volume_shape):
        raise ValueError(f"volume splat kernel: out {tuple(gvol.shape)}, "
                         f"want {tuple(volume_shape)}")
    _check_args(gvol, ndc)
    if g.shape != (*ndc.shape[:2], C) or g.dtype != torch.float32 or \
            g.device != gvol.device or not g.is_contiguous():
        raise ValueError(f"volume splat kernel: bad cotangent "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    if adds is not None and (adds.shape != (2,) or
                             adds.dtype != torch.int64 or
                             adds.device != gvol.device):
        raise ValueError(f"volume splat kernel: adds must be an int64 (2,) "
                         f"tensor on {gvol.device}")
    N, S, _ = ndc.shape
    rc = library().volume_splat_bwd(
        g.data_ptr(), ndc.data_ptr(), gvol.data_ptr(), N * S, D, hp, wp, C,
        None if adds is None else adds.data_ptr(), stream_of(g))
    check(rc, "volume_splat_bwd")
    sample_volume.bwd_launches += 1
    return gvol


def volume_splat_plain(g, ndc, volume):
    """Plain twin of K5's backward: the grid_sample VJP with respect to
    the volume."""
    with torch.enable_grad():
        v = volume.detach().requires_grad_()
        return torch.autograd.grad(sample_volume_plain(v, ndc), v, g)[0]


class _SampleVolume(torch.autograd.Function):

    @staticmethod
    def forward(ctx, volume, ndc):
        ctx.save_for_backward(volume, ndc)
        return volume_gather_kernel(volume, ndc)

    @staticmethod
    def backward(ctx, g):
        volume, ndc = ctx.saved_tensors
        g = g.contiguous()
        g_vol = g_ndc = None
        if ctx.needs_input_grad[0]:
            g_vol = volume_splat_kernel(g, ndc, volume.shape)
        if ctx.needs_input_grad[1]:
            with torch.enable_grad():
                nd = ndc.detach().requires_grad_()
                out = grid_sample_3d(volume.detach(), nd * 2.0 - 1.0)
                g_ndc, = torch.autograd.grad(out, nd, g)
        return g_vol, g_ndc


def sample_volume(volume, ndc):
    """Trilinear zeros-padded fetch of `volume` (D, hp, wp, C) at `ndc`
    (N, S, 3) in [0, 1] -> (N, S, C), differentiable in both arguments."""
    if volume.device.type == "cpu":
        return sample_volume_plain(volume, ndc)
    if volume.device.type != "cuda":
        raise ValueError(f"sample_volume: no kernel for {volume.device}")
    return _SampleVolume.apply(volume, ndc)


sample_volume.launches = 0      # forward gathers
sample_volume.bwd_launches = 0  # backward splats

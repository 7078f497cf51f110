"""K6: fused volume fetch + PE + v0 MLP + compositing, and its plain twin.

`render_v0` launches csrc/render_v0.cu for CUDA tensors and runs the plain
PyTorch twin `render_v0_plain` for CPU tensors; any other device raises.
Per ray: trilinear zeros-padded fetch of the 8-channel encoding volume at
each sample's NDC, concatenated with the sample's 12 K4 colour channels,
PE of the NDC (10 frequencies), the v0 MLP with the ray's unit direction
in the reference frame, and front-to-back compositing with the
reference's quirks (no delta-t, 1e-10 transmittance epsilon), no early
stop. White background is the caller's.

Replaces mvsnerf_tpu/ops/pallas_render_tiled.py:313 `tiled_render_v0`
(hybrid form, exact colours streamed in). What bounds it on the H100:
f32 FMA issue for the ~125k multiply-adds per sample.
"""

from __future__ import annotations

import torch

from .._build import check, library, stream_of
from .compositing import raw2outputs
from .encoding import positional_encoding
from .interp import index_point_feature

# csrc/render_v0.cu's packed layer order: (module attribute, in, out)
_LAYERS = ([("pts_linears.0", 63, 128), ("pts_bias", 20, 128)]
           + [(f"pts_linears.{i}", 128, 128) for i in range(1, 5)]
           + [("pts_linears.5", 191, 128), ("alpha_linear", 128, 1),
              ("feature_linear", 128, 128), ("views_linears.0", 131, 64),
              ("rgb_linear", 64, 3)])
N_WEIGHTS = sum(i * o + o for _, i, o in _LAYERS)


def pack_v0_weights(mlp):
    """The v0 MLP's weights as the kernel reads them: for each layer of
    `_LAYERS`, the (in, out) matrix row-major, then the bias."""
    parts = []
    for name, n_in, n_out in _LAYERS:
        lin = mlp.nerf.get_submodule(name)
        if lin.weight.shape != (n_out, n_in):
            raise ValueError(f"render kernel: {name} is "
                             f"{tuple(lin.weight.shape)}, want "
                             f"({n_out}, {n_in})")
        parts += [lin.weight.detach().t().reshape(-1), lin.bias.detach()]
    return torch.cat(parts).float().contiguous()


def render_v0_plain(pts_ndc, z_vals, colors, dirs, volume, mlp):
    """Plain PyTorch twin of K6; same arguments and result as
    `render_v0`."""
    feats = torch.cat([index_point_feature(volume, pts_ndc), colors], dim=-1)
    views = dirs[:, None].expand(-1, pts_ndc.shape[1], -1)
    x = torch.cat([positional_encoding(pts_ndc, 10), feats, views], dim=-1)
    out = raw2outputs(mlp(x), z_vals)
    return {k: out[k] for k in ("rgb", "depth", "acc")}


def render_v0(pts_ndc, z_vals, colors, dirs, volume, mlp):
    """Render N rays of S samples through the v0 MLP.

    Args:
        pts_ndc: (N, S, 3) sample NDC in [0, 1] (x, y, z).
        z_vals: (N, S) metric depths.
        colors: (N, S, 12) per-view [RGB, mask] blocks (K4's output).
        dirs: (N, 3) unit ray directions in the reference frame.
        volume: (D, hp, wp, 8) encoding volume.
        mlp: the v0 `MVSNeRF` module.
    Returns:
        dict rgb (N, 3), depth (N,), acc (N,); no white background.
    """
    if pts_ndc.device.type == "cpu":
        return render_v0_plain(pts_ndc, z_vals, colors, dirs, volume, mlp)
    if pts_ndc.device.type != "cuda":
        raise ValueError(f"render_v0: no kernel for {pts_ndc.device}")
    N, S, _ = pts_ndc.shape
    D, hp, wp, c = volume.shape
    dev = pts_ndc.device
    if pts_ndc.shape[-1] != 3 or z_vals.shape != (N, S) or \
            colors.shape != (N, S, 12) or dirs.shape != (N, 3) or c != 8:
        raise ValueError(
            f"render kernel: bad shapes ndc {tuple(pts_ndc.shape)}, z "
            f"{tuple(z_vals.shape)}, colors {tuple(colors.shape)}, dirs "
            f"{tuple(dirs.shape)}, volume {tuple(volume.shape)}")
    if S % 8 or N < 1 or N >= 2 ** 31:
        raise ValueError(f"render kernel: needs S % 8 == 0 and 0 < N < "
                         f"2**31, got N={N}, S={S}")
    weights = pack_v0_weights(mlp)
    for name, t in (("pts_ndc", pts_ndc), ("z_vals", z_vals),
                    ("colors", colors), ("dirs", dirs), ("volume", volume),
                    ("weights", weights)):
        if t.device != dev or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"render kernel: {name} must be contiguous "
                             f"float32 on {dev}")
    out = torch.empty((N, 5), device=dev)
    rc = library().render_v0(
        pts_ndc.data_ptr(), z_vals.data_ptr(), colors.data_ptr(),
        dirs.data_ptr(), volume.data_ptr(), weights.data_ptr(),
        out.data_ptr(), N, S, D, hp, wp, N_WEIGHTS, stream_of(pts_ndc))
    check(rc, "render_v0")
    render_v0.launches += 1
    return {"rgb": out[:, :3], "depth": out[:, 3], "acc": out[:, 4]}


render_v0.launches = 0

"""K6, K6b and K8: fused PE + v0 MLP + compositing, and their plain twins.

`render_v0` renders rays over an encoding volume: K6 when the 12 per-sample
colour channels of K4 are given with an 8-channel volume (the hybrid
mode), K6b when `colors` is None and the volume is the colour-baked
20-channel one (the `tiled` mode). `render_v0_feats` (K8) renders rays
whose 20 features are gathered already (the chunked mode). All three
launch one kernel body of csrc/render_v0.cu for CUDA tensors and run
their plain PyTorch twins (`render_v0_plain`, `render_v0_feats_plain`) for
CPU tensors; any other device raises.

Per ray: the features (trilinear zeros-padded fetch of the volume's
channels at each sample's NDC, then the buffered ones), PE of the NDC (10
frequencies), the v0 MLP with the ray's unit direction in the reference
frame, and front-to-back compositing with the reference's quirks (no
delta-t, 1e-10 transmittance epsilon), no early stop. White background is
the caller's.

Replaces mvsnerf_tpu/ops/pallas_render_tiled.py:313 `tiled_render_v0`
(hybrid and baked forms) and mvsnerf_tpu/ops/pallas_kernels.py:196
`fused_render_v0`. What bounds them on the H100: f32 FMA issue for the
~125k multiply-adds per sample.
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
N_FEATS = 20  # the MLP's feature inputs (pts_bias)


def pack_v0_weights(mlp, transposed: bool = False):
    """The v0 MLP's weights as the kernels read them: for each layer of
    `_LAYERS`, the (in, out) matrix row-major, then the bias. With
    `transposed`, each matrix is stored (out, in) instead (nn.Linear's own
    layout) at the same offsets. Built without detaching, so a gradient of
    the packed vector flows back onto the module's parameters."""
    parts = []
    for name, n_in, n_out in _LAYERS:
        lin = mlp.nerf.get_submodule(name)
        if lin.weight.shape != (n_out, n_in):
            raise ValueError(f"v0 kernel: {name} is "
                             f"{tuple(lin.weight.shape)}, want "
                             f"({n_out}, {n_in})")
        w = lin.weight if transposed else lin.weight.t()
        parts += [w.reshape(-1), lin.bias]
    return torch.cat(parts).float().contiguous()


def render_v0_feats_plain(pts_ndc, feats, dirs, z_vals, mlp):
    """Plain PyTorch twin of K8; same arguments and result as
    `render_v0_feats`."""
    views = dirs[:, None].expand(-1, pts_ndc.shape[1], -1)
    x = torch.cat([positional_encoding(pts_ndc, 10), feats, views], dim=-1)
    out = raw2outputs(mlp(x), z_vals)
    return {k: out[k] for k in ("rgb", "depth", "acc", "weights")}


def render_v0_plain(pts_ndc, z_vals, colors, dirs, volume, mlp):
    """Plain PyTorch twin of K6 and K6b; same arguments and result as
    `render_v0`."""
    feats = index_point_feature(volume, pts_ndc)
    if colors is not None:
        feats = torch.cat([feats, colors], dim=-1)
    out = render_v0_feats_plain(pts_ndc, feats, dirs, z_vals, mlp)
    return {k: out[k] for k in ("rgb", "depth", "acc")}


def _check_rays(name, pts_ndc, z_vals, dirs):
    N, S, _ = pts_ndc.shape
    if pts_ndc.shape[-1] != 3 or z_vals.shape != (N, S) or \
            dirs.shape != (N, 3):
        raise ValueError(f"{name} kernel: bad shapes ndc "
                         f"{tuple(pts_ndc.shape)}, z {tuple(z_vals.shape)}, "
                         f"dirs {tuple(dirs.shape)}")
    if S % 8 or N < 1 or N >= 2 ** 31:
        raise ValueError(f"{name} kernel: needs S % 8 == 0 and 0 < N < "
                         f"2**31, got N={N}, S={S}")
    return N, S


def _check_tensors(name, dev, **tensors):
    for key, t in tensors.items():
        if t.device != dev or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"{name} kernel: {key} must be contiguous "
                             f"float32 on {dev}")


def render_v0(pts_ndc, z_vals, colors, dirs, volume, mlp):
    """Render N rays of S samples through the v0 MLP over a volume.

    Args:
        pts_ndc: (N, S, 3) sample NDC in [0, 1] (x, y, z).
        z_vals: (N, S) metric depths.
        colors: (N, S, 12) per-view [RGB, mask] blocks (K4's output) with an
            8-channel volume (K6), or None with the colour-baked
            20-channel volume (K6b).
        dirs: (N, 3) unit ray directions in the reference frame.
        volume: (D, hp, wp, 8) encoding volume, or (D, hp, wp, 20) baked.
        mlp: the v0 `MVSNeRF` module.
    Returns:
        dict rgb (N, 3), depth (N,), acc (N,); no white background.
    """
    if pts_ndc.device.type == "cpu":
        return render_v0_plain(pts_ndc, z_vals, colors, dirs, volume, mlp)
    if pts_ndc.device.type != "cuda":
        raise ValueError(f"render_v0: no kernel for {pts_ndc.device}")
    N, S = _check_rays("render", pts_ndc, z_vals, dirs)
    D, hp, wp, c = volume.shape
    dev = pts_ndc.device
    want = 8 if colors is not None else N_FEATS
    if c != want or (colors is not None and colors.shape != (N, S, 12)):
        raise ValueError(
            f"render kernel: volume {tuple(volume.shape)} with colors "
            f"{None if colors is None else tuple(colors.shape)}; needs an "
            f"8-channel volume with (N, S, 12) colours or a 20-channel one "
            f"without")
    with torch.no_grad():
        weights = pack_v0_weights(mlp)
    extra = {} if colors is None else {"colors": colors}
    _check_tensors("render", dev, pts_ndc=pts_ndc, z_vals=z_vals, dirs=dirs,
                   volume=volume, weights=weights, **extra)
    out = torch.empty((N, 5), device=dev)
    rc = library().render_v0(
        pts_ndc.data_ptr(), z_vals.data_ptr(),
        None if colors is None else colors.data_ptr(), dirs.data_ptr(),
        volume.data_ptr(), weights.data_ptr(), out.data_ptr(), N, S, D, hp,
        wp, c, N_WEIGHTS, stream_of(pts_ndc))
    check(rc, "render_v0")
    if colors is None:
        render_v0.baked_launches += 1
    else:
        render_v0.launches += 1
    return {"rgb": out[:, :3], "depth": out[:, 3], "acc": out[:, 4]}


render_v0.launches = 0         # K6: hybrid (colours streamed in)
render_v0.baked_launches = 0   # K6b: the colour-baked volume


def render_v0_feats(pts_ndc, feats, dirs, z_vals, mlp):
    """K8: render N rays of S samples whose MLP features are gathered.

    Args:
        pts_ndc: (N, S, 3) sample NDC (the PE's input).
        feats: (N, S, 20) per-sample features (8 volume + 12 colour
            channels, or the baked volume's 20).
        dirs: (N, 3) unit ray directions in the reference frame.
        z_vals: (N, S) metric depths.
        mlp: the v0 `MVSNeRF` module.
    Returns:
        dict rgb (N, 3), depth (N,), acc (N,), weights (N, S); no white
        background.
    """
    if pts_ndc.device.type == "cpu":
        return render_v0_feats_plain(pts_ndc, feats, dirs, z_vals, mlp)
    if pts_ndc.device.type != "cuda":
        raise ValueError(f"render_v0_feats: no kernel for {pts_ndc.device}")
    N, S = _check_rays("render_v0_feats", pts_ndc, z_vals, dirs)
    if feats.shape != (N, S, N_FEATS):
        raise ValueError(f"render_v0_feats kernel: feats "
                         f"{tuple(feats.shape)}, want ({N}, {S}, 20)")
    dev = pts_ndc.device
    with torch.no_grad():
        weights = pack_v0_weights(mlp)
    _check_tensors("render_v0_feats", dev, pts_ndc=pts_ndc, feats=feats,
                   dirs=dirs, z_vals=z_vals, weights=weights)
    out = torch.empty((N, 5), device=dev)
    wout = torch.empty((N, S), device=dev)
    rc = library().render_v0_feats(
        pts_ndc.data_ptr(), z_vals.data_ptr(), feats.data_ptr(),
        dirs.data_ptr(), weights.data_ptr(), out.data_ptr(), wout.data_ptr(),
        N, S, N_WEIGHTS, stream_of(pts_ndc))
    check(rc, "render_v0_feats")
    render_v0_feats.launches += 1
    return {"rgb": out[:, :3], "depth": out[:, 3], "acc": out[:, 4],
            "weights": wout}


render_v0_feats.launches = 0

"""K6, K6b and K8: fused PE + v0 MLP + compositing; K11 the same for the
v1 attention MLP; and their plain twins.

`render_v0` renders rays over an encoding volume: K6 when the 12 per-sample
colour channels of K4 are given with an 8-channel volume (the hybrid
mode), K6b when `colors` is None and the volume is the colour-baked
20-channel one (the `tiled` mode). `render_v0_feats` (K8) renders rays
whose 20 features are gathered already (the chunked mode, and the fusion
trainer's local renders, which also ask it for each sample's alpha). All three
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
`fused_render_v0`. The kernel runs the MLP's ~1.26e5 multiply-adds a
sample on the tensor cores in 3xTF32 (csrc/mlp_tc.cuh): each wrapper call
packs the weights twice, as the f32 vector of `pack_v0_weights` (biases,
heads, the direction rows) and as `pack_v0_weights_tc`, the padded
matrices split into TF32 hi/lo pieces (`split_tf32`) in the order the
kernel's fragments read them. Nothing is cached across calls: a trainer
changes the MLP between them.

`render_v1_feats` (K11, csrc/render_v1.cu) renders gathered features
through the v1 MLP (`Renderer_attention`): the per-sample colour attention
over the three source views' tokens in f32, then the additive-bias trunk
and the heads on the tensor cores as K8's, packed by `pack_v1_weights` and
`pack_v1_weights_tc`. It replaces no TPU kernel (JAX renders v1 in XLA,
mvsnerf_tpu/models/nerf_mlp.py:117 `mlp_v1_apply`); its twin
`render_v1_feats_plain` is the module's forward and `raw2outputs`.
"""

from __future__ import annotations

import functools

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


def _pack_offsets():
    """Layer name -> offset of its (in, out) matrix in `pack_v0_weights`."""
    offsets, pos = {}, 0
    for name, n_in, n_out in _LAYERS:
        offsets[name] = pos
        pos += n_in * n_out + n_out
    return offsets


# csrc/mlp_tc.cuh's tensor-core stream, in the kernel's order: (the
# header's offset name, packed layer, the layer's input row at each padded
# K row or -1 for a zero row, N). Layer 5 reads [PE (63) | h (128)], padded
# after the PE; views_linears.0 streams its 128 feature rows (the 3
# direction rows stay f32, once a ray).
_PAD = -1
TC_LAYERS = (
    ("TC_PTS_BIAS", "pts_bias", list(range(20)) + [_PAD] * 4, 128),
    ("TC_PTS_0", "pts_linears.0", list(range(63)) + [_PAD], 128),
    *((f"TC_PTS_{i}", f"pts_linears.{i}", list(range(128)), 128)
      for i in range(1, 5)),
    ("TC_PTS_5", "pts_linears.5",
     list(range(63)) + [_PAD] + list(range(63, 191)), 128),
    ("TC_FEATURE", "feature_linear", list(range(128)), 128),
    ("TC_VIEWS", "views_linears.0", list(range(128)), 64))


def _stream_offsets(layers):
    """Offset name -> offset in floats of each layer's hi/lo fragments (K x
    N x 2 floats) in a stream laid out as `TC_LAYERS` (or `TCT_LAYERS`:
    columns for rows, K for N), and its length."""
    offsets, pos = {}, 0
    for name, _, rows, n in layers:
        offsets[name] = pos
        pos += len(rows) * n * 2
    return offsets, pos


TC_OFFSETS, TC_TOTAL = _stream_offsets(TC_LAYERS)


def split_tf32(x):
    """Split float32 `x` into (hi, lo): hi is x rounded to TF32's 10
    mantissa bits (to nearest, ties away from zero, as `cvt.rna.tf32.f32`
    rounds), lo the remainder x - hi rounded likewise. hi + lo rebuilds x
    within 2**-21 of |x|."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def fragment_order(m):
    """A padded (K, N) matrix as the kernel's B fragments read it: (K / 8,
    N / 8, 32, 2), lane 4 g + t of k-step kb and n-tile nb holding
    m[8 kb + t, 8 nb + g] and m[8 kb + t + 4, 8 nb + g]."""
    K, N = m.shape
    return m.reshape(K // 8, 2, 4, N // 8, 8).permute(0, 3, 4, 2, 1).reshape(
        K // 8, N // 8, 32, 2)


def _stream_index(layers, offsets, n_weights):
    """For each (lane, b0 / b1) slot of a stream's hi half (`layers` as
    `TC_LAYERS`), the index of its weight in the f32 pack whose layers
    start at `offsets`, `n_weights` for a zero row."""
    parts = []
    for _, layer, rows, n in layers:
        m = torch.full((len(rows), n), n_weights, dtype=torch.long)
        for k, r in enumerate(rows):
            if r != _PAD:
                m[k] = offsets[layer] + r * n + torch.arange(n)
        parts.append(fragment_order(m).reshape(-1))
    return torch.cat(parts)


@functools.lru_cache(maxsize=None)
def _tc_index(device):
    """`_stream_index` of the v0 stream: a layout, the same for every MLP,
    so kept per device."""
    return _stream_index(TC_LAYERS, _pack_offsets(), N_WEIGHTS).to(device)


def _split_stream(weights, index):
    """The stream from an f32 pack and its `_stream_index`: each lane's
    {b0 hi, b1 hi, b0 lo, b1 lo} together."""
    ext = torch.cat([weights, weights.new_zeros(1)])
    pairs = ext[index].view(-1, 2)
    hi, lo = split_tf32(pairs)
    return torch.cat([hi, lo], 1).reshape(-1)


def pack_v0_weights_tc(weights):
    """The tensor-core stream of csrc/mlp_tc.cuh from the f32 vector
    `weights` (`pack_v0_weights`' layout): each layer of `TC_LAYERS` zero-
    padded to K rows, in fragment order, with each lane's {b0 hi, b1 hi,
    b0 lo, b1 lo} together; (TC_TOTAL,) float32."""
    return _split_stream(weights, _tc_index(weights.device))


# The transposed stream of K7's backward (csrc/mlp_tc.cuh `TCT_*`), in the
# order its deltas read it: (the header's offset name, packed layer, the
# layer's input row at each padded N column or -1 for a zero column, K =
# the layer's outputs). Layer `name`'s (K, N) matrix is W^T: column n is
# input row `rows[n]` (pts_linears.5: its h rows only; pts_bias: 20 + 4).
TCT_LAYERS = (
    ("TCT_VIEWS", "views_linears.0", list(range(128)), 64),
    ("TCT_FEATURE", "feature_linear", list(range(128)), 128),
    ("TCT_PTS_5", "pts_linears.5", list(range(63, 191)), 128),
    *((f"TCT_PTS_{i}", f"pts_linears.{i}", list(range(128)), 128)
      for i in range(4, 0, -1)),
    ("TCT_PTS_BIAS", "pts_bias", list(range(20)) + [_PAD] * 4, 128))


TCT_OFFSETS, TCT_TOTAL = _stream_offsets(TCT_LAYERS)


@functools.lru_cache(maxsize=None)
def _tct_index(device):
    """`_tc_index` for the transposed stream."""
    offsets, width = _pack_offsets(), dict((n, o) for n, _, o in _LAYERS)
    parts = []
    for _, layer, cols, k in TCT_LAYERS:
        m = torch.full((k, len(cols)), N_WEIGHTS, dtype=torch.long)
        for n, r in enumerate(cols):
            if r != _PAD:
                m[:, n] = offsets[layer] + r * width[layer] + torch.arange(k)
        parts.append(fragment_order(m).reshape(-1))
    return torch.cat(parts).to(device)


def pack_v0_weights_tct(weights):
    """The transposed stream of K7's backward from `pack_v0_weights`'
    vector, laid out and split as `pack_v0_weights_tc`'s; (TCT_TOTAL,)
    float32. On a card K7 writes it with its own kernel
    (csrc/mlp_v0_train.cu `mlp_pack_kernel`); this is its reference."""
    return _split_stream(weights, _tct_index(weights.device))


def require_v0_mlp(mlp, what: str):
    """Raise unless `mlp` is the v0 MLP at D=6, W=128, the one MLP the
    kernels K6, K6b, K7 and K8 compute (v2 has v0's shapes, so a shape
    check alone would let it through; v1 has K11 alone). JAX's kernels are
    v0-only too (mvsnerf_tpu/render/tiled.py:112-113, pallas_mlp.py)."""
    if mlp.fused_body != "v0":
        raise ValueError(
            f"{what}: the kernel computes the v0 MLP at D=6, W=128, got "
            f"--net_type {mlp.net_type} --netdepth {mlp.D} --netwidth "
            f"{mlp.W}; render it with --render_mode chunked")


def pack_v0_weights(mlp):
    """The v0 MLP's weights as the kernels read them: for each layer of
    `_LAYERS`, the (in, out) matrix row-major, then the bias. Built without
    detaching, so a gradient of the packed vector flows back onto the
    module's parameters."""
    require_v0_mlp(mlp, "v0 kernel")
    parts = []
    for name, n_in, n_out in _LAYERS:
        lin = mlp.nerf.get_submodule(name)
        if lin.weight.shape != (n_out, n_in):
            raise ValueError(f"v0 kernel: {name} is "
                             f"{tuple(lin.weight.shape)}, want "
                             f"({n_out}, {n_in})")
        parts += [lin.weight.t().reshape(-1), lin.bias]
    return torch.cat(parts).float().contiguous()


def render_v0_feats_plain(pts_ndc, feats, dirs, z_vals, mlp,
                          with_alpha: bool = False):
    """Plain PyTorch twin of K8; same arguments and result as
    `render_v0_feats`."""
    views = dirs[:, None].expand(-1, pts_ndc.shape[1], -1)
    x = torch.cat([positional_encoding(pts_ndc, 10), feats, views], dim=-1)
    out = raw2outputs(mlp(x), z_vals)
    keys = ("rgb", "depth", "acc", "weights") + (("alpha",) if with_alpha
                                                 else ())
    return {k: out[k] for k in keys}


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


def _packed(mlp):
    """The f32 pack and its tensor-core stream, made anew each call."""
    with torch.no_grad():
        weights = pack_v0_weights(mlp)
        return weights, pack_v0_weights_tc(weights)


def render_v0_kernel(pts_ndc, z_vals, colors, dirs, volume, mlp):
    """`render_v0` on the card: checks the arguments, then launches K6
    (colours given) or K6b (colours None)."""
    N, S = _check_rays("render", pts_ndc, z_vals, dirs)
    if volume.dim() != 4:
        raise ValueError(f"render kernel: volume {tuple(volume.shape)} is "
                         f"not (D, hp, wp, C)")
    D, hp, wp, c = volume.shape
    dev = pts_ndc.device
    want = 8 if colors is not None else N_FEATS
    if c != want or (colors is not None and colors.shape != (N, S, 12)):
        raise ValueError(
            f"render kernel: volume {tuple(volume.shape)} with colors "
            f"{None if colors is None else tuple(colors.shape)}; needs an "
            f"8-channel volume with (N, S, 12) colours or a 20-channel one "
            f"without")
    extra = {} if colors is None else {"colors": colors}
    _check_tensors("render", dev, pts_ndc=pts_ndc, z_vals=z_vals, dirs=dirs,
                   volume=volume, **extra)
    weights, tc = _packed(mlp)
    _check_tensors("render", dev, weights=weights)
    out = torch.empty((N, 5), device=dev)
    rc = library().render_v0(
        pts_ndc.data_ptr(), z_vals.data_ptr(),
        None if colors is None else colors.data_ptr(), dirs.data_ptr(),
        volume.data_ptr(), weights.data_ptr(), tc.data_ptr(), out.data_ptr(),
        N, S, D, hp, wp, c, N_WEIGHTS, TC_TOTAL, stream_of(pts_ndc))
    check(rc, "render_v0")
    if colors is None:
        render_v0.baked_launches += 1
    else:
        render_v0.launches += 1
    return {"rgb": out[:, :3], "depth": out[:, 3], "acc": out[:, 4]}


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
    return render_v0_kernel(pts_ndc, z_vals, colors, dirs, volume, mlp)


render_v0.launches = 0         # K6: hybrid (colours streamed in)
render_v0.baked_launches = 0   # K6b: the colour-baked volume


def render_v0_feats_kernel(pts_ndc, feats, dirs, z_vals, mlp,
                           with_alpha: bool = False):
    """`render_v0_feats` on the card: checks the arguments, then launches
    K8 (with an alpha buffer only when `with_alpha`)."""
    N, S = _check_rays("render_v0_feats", pts_ndc, z_vals, dirs)
    if feats.shape != (N, S, N_FEATS):
        raise ValueError(f"render_v0_feats kernel: feats "
                         f"{tuple(feats.shape)}, want ({N}, {S}, 20)")
    dev = pts_ndc.device
    _check_tensors("render_v0_feats", dev, pts_ndc=pts_ndc, feats=feats,
                   dirs=dirs, z_vals=z_vals)
    weights, tc = _packed(mlp)
    _check_tensors("render_v0_feats", dev, weights=weights)
    out = torch.empty((N, 5), device=dev)
    wout = torch.empty((N, S), device=dev)
    aout = torch.empty((N, S), device=dev) if with_alpha else None
    rc = library().render_v0_feats(
        pts_ndc.data_ptr(), z_vals.data_ptr(), feats.data_ptr(),
        dirs.data_ptr(), weights.data_ptr(), tc.data_ptr(), out.data_ptr(),
        wout.data_ptr(), None if aout is None else aout.data_ptr(), N, S,
        N_WEIGHTS, TC_TOTAL, stream_of(pts_ndc))
    check(rc, "render_v0_feats")
    render_v0_feats.launches += 1
    res = {"rgb": out[:, :3], "depth": out[:, 3], "acc": out[:, 4],
           "weights": wout}
    if with_alpha:
        res["alpha"] = aout
    return res


def render_v0_feats(pts_ndc, feats, dirs, z_vals, mlp,
                    with_alpha: bool = False):
    """K8: render N rays of S samples whose MLP features are gathered.

    Args:
        pts_ndc: (N, S, 3) sample NDC (the PE's input).
        feats: (N, S, 20) per-sample features (8 volume + 12 colour
            channels, or the baked volume's 20).
        dirs: (N, 3) unit ray directions in the reference frame.
        z_vals: (N, S) metric depths.
        mlp: the v0 `MVSNeRF` module.
        with_alpha: also return each sample's alpha, 1 - exp(-sigma), as
            the kernel computes it (not rebuilt from the weights: their
            1e-10 transmittance epsilon and opaque rays' cancellation would
            spoil it).
    Returns:
        dict rgb (N, 3), depth (N,), acc (N,), weights (N, S) (and alpha
        (N, S)); no white background.
    """
    if pts_ndc.device.type == "cpu":
        return render_v0_feats_plain(pts_ndc, feats, dirs, z_vals, mlp,
                                     with_alpha)
    if pts_ndc.device.type != "cuda":
        raise ValueError(f"render_v0_feats: no kernel for {pts_ndc.device}")
    return render_v0_feats_kernel(pts_ndc, feats, dirs, z_vals, mlp,
                                  with_alpha)


render_v0_feats.launches = 0


# ---------------------------------------------------------------- K11 ----

# csrc/render_v1.cu's packed layer order: (module attribute, in, out, with
# a bias); the LayerNorm's scale and shift are a (1, 12) matrix and its
# "bias"
_V1_LAYERS = ([("pts_linears.0", 63, 128, True), ("pts_bias", 11, 128, True)]
              + [(f"pts_linears.{i}", 128, 128, True) for i in range(1, 6)]
              + [("alpha_linear", 128, 1, True),
                 ("feature_linear", 128, 128, True),
                 ("views_linears.0", 131, 64, True),
                 ("rgb_linear", 64, 3, True),
                 ("color_attention.w_qs", 12, 16, False),
                 ("color_attention.w_ks", 12, 16, False),
                 ("color_attention.w_vs", 12, 16, False),
                 ("color_attention.fc", 16, 12, False),
                 ("color_attention.layer_norm", 1, 12, True),
                 ("weight_out", 12, 3, True)])
N_WEIGHTS_V1 = sum(i * o + (o if b else 0) for _, i, o, b in _V1_LAYERS)


def _pack_v1_offsets():
    """Layer name -> offset of its (in, out) matrix in `pack_v1_weights`."""
    offsets, pos = {}, 0
    for name, n_in, n_out, bias in _V1_LAYERS:
        offsets[name] = pos
        pos += n_in * n_out + (n_out if bias else 0)
    return offsets


# csrc/render_v1.cu's tensor-core stream (`TC1_*`), as `TC_LAYERS`:
# pts_bias reads [volume (8) | colour (3)], padded to K 16; no PE skip
TC1_LAYERS = (
    ("TC1_PTS_BIAS", "pts_bias", list(range(11)) + [_PAD] * 5, 128),
    ("TC1_PTS_0", "pts_linears.0", list(range(63)) + [_PAD], 128),
    *((f"TC1_PTS_{i}", f"pts_linears.{i}", list(range(128)), 128)
      for i in range(1, 6)),
    ("TC1_FEATURE", "feature_linear", list(range(128)), 128),
    ("TC1_VIEWS", "views_linears.0", list(range(128)), 64))
TC1_OFFSETS, TC1_TOTAL = _stream_offsets(TC1_LAYERS)


@functools.lru_cache(maxsize=None)
def _tc1_index(device):
    """`_stream_index` of the v1 stream, kept per device."""
    return _stream_index(TC1_LAYERS, _pack_v1_offsets(),
                         N_WEIGHTS_V1).to(device)


def pack_v1_weights(mlp):
    """The v1 MLP's weights as K11 reads them: for each layer of
    `_V1_LAYERS`, the (in, out) matrix row-major, then its bias where it
    has one."""
    if mlp.fused_body != "v1":
        raise ValueError(
            f"v1 kernel: the kernel computes the v1 MLP at D=6, W=128, got "
            f"--net_type {mlp.net_type} --netdepth {mlp.D} --netwidth "
            f"{mlp.W}")
    parts = []
    for name, n_in, n_out, bias in _V1_LAYERS:
        mod = mlp.nerf.get_submodule(name)
        if mod.weight.numel() != n_in * n_out:
            raise ValueError(f"v1 kernel: {name} is "
                             f"{tuple(mod.weight.shape)}, want "
                             f"({n_out}, {n_in})")
        parts.append(mod.weight.reshape(n_out, n_in).t().reshape(-1))
        if bias:
            parts.append(mod.bias)
    return torch.cat(parts).float().contiguous()


def pack_v1_weights_tc(weights):
    """K11's tensor-core stream from `pack_v1_weights`' vector, laid out
    and split as `pack_v0_weights_tc`'s; (TC1_TOTAL,) float32."""
    return _split_stream(weights, _tc1_index(weights.device))


def render_v1_feats_plain(pts_ndc, feats, dirs, z_vals, mlp):
    """Plain PyTorch twin of K11: the module's forward and `raw2outputs`;
    same arguments and result as `render_v1_feats`."""
    views = dirs[:, None].expand(-1, pts_ndc.shape[1], -1)
    x = torch.cat([positional_encoding(pts_ndc, 10), feats, views], dim=-1)
    raw = mlp(x)
    out = raw2outputs(raw, z_vals)
    res = {k: out[k] for k in ("rgb", "depth", "acc", "weights", "alpha")}
    res["feats"] = torch.cat([feats[..., :8], raw[..., 4:]], dim=-1)
    return res


def render_v1_feats_kernel(pts_ndc, feats, dirs, z_vals, mlp):
    """`render_v1_feats` on the card: checks the arguments, packs the
    weights (anew each call, as K8's) and launches K11."""
    N, S = _check_rays("render_v1_feats", pts_ndc, z_vals, dirs)
    if feats.shape != (N, S, N_FEATS):
        raise ValueError(f"render_v1_feats kernel: feats "
                         f"{tuple(feats.shape)}, want ({N}, {S}, 20)")
    dev = pts_ndc.device
    _check_tensors("render_v1_feats", dev, pts_ndc=pts_ndc, feats=feats,
                   dirs=dirs, z_vals=z_vals)
    with torch.no_grad():
        weights = pack_v1_weights(mlp)
        tc = pack_v1_weights_tc(weights)
    _check_tensors("render_v1_feats", dev, weights=weights)
    out = torch.empty((N, 5), device=dev)
    wout = torch.empty((N, S), device=dev)
    aout = torch.empty((N, S), device=dev)
    fout = torch.empty((N, S, 14), device=dev)
    rc = library().render_v1_feats(
        pts_ndc.data_ptr(), z_vals.data_ptr(), feats.data_ptr(),
        dirs.data_ptr(), weights.data_ptr(), tc.data_ptr(), out.data_ptr(),
        wout.data_ptr(), aout.data_ptr(), fout.data_ptr(), N, S,
        N_WEIGHTS_V1, TC1_TOTAL, stream_of(pts_ndc))
    check(rc, "render_v1_feats")
    render_v1_feats.launches += 1
    return {"rgb": out[:, :3], "depth": out[:, 3], "acc": out[:, 4],
            "weights": wout, "alpha": aout, "feats": fout}


def render_v1_feats(pts_ndc, feats, dirs, z_vals, mlp):
    """K11: render N rays of S samples through the v1 attention MLP from
    their gathered features (csrc/render_v1.cu).

    Args:
        pts_ndc: (N, S, 3) sample NDC (the PE's input).
        feats: (N, S, 20) per-sample features: 8 volume channels, then
            each source view's [RGB, mask].
        dirs: (N, 3) unit ray directions in the reference frame.
        z_vals: (N, S) metric depths.
        mlp: the v1 `MVSNeRF` module at D=6, W=128.
    Returns:
        dict rgb (N, 3), depth (N,), acc (N,), weights and alpha (N, S),
        and feats (N, S, 14), each sample's volume channels and twice its
        colour fused by the attention (the module's outputs 4-9), as the
        module's route folds them; no white background.
    """
    if pts_ndc.device.type == "cpu":
        return render_v1_feats_plain(pts_ndc, feats, dirs, z_vals, mlp)
    if pts_ndc.device.type != "cuda":
        raise ValueError(f"render_v1_feats: no kernel for {pts_ndc.device}")
    return render_v1_feats_kernel(pts_ndc, feats, dirs, z_vals, mlp)


render_v1_feats.launches = 0

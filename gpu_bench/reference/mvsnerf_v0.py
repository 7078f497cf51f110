"""Plain PyTorch MVSNeRF with the v0 MLP: the benchmark's reference.

Written from the published description (Chen et al., "MVSNeRF: Fast
Generalizable Radiance Field Reconstruction from Multi-View Stereo",
arXiv:2103.15595) and the authors' code (apchenstu/mvsnerf: models.py,
renderer.py, utils.py, train_mvs_nerf_finetuning_pl.py). It imports torch
alone: no kernel, no cache, no batching beyond blocks of rays that bound
its memory, and nothing of the measured program. Float32 with TF32 off
unless a caller turns TF32 on (the precision control).

Its quirks are the authors', kept: MVSNet normalises with batch
statistics at inference too (InPlaceABN in train mode, LeakyReLU 0.01);
the v0 MLP's bias is multiplicative; alpha = 1 - exp(-sigma) with no
inter-sample distance and a 1e-10 in the transmittance; the sample
coordinates are the reference view's NDC remapped into the padded volume.

Parameters are one dict of tensors under the authors' checkpoint keys
(`network_fn_state_dict` under `nerf.`, `network_mvs_state_dict` under
`feature.` and `cost_reg_2.`); `param_table` lists them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MLP_D, MLP_W, SKIP = 6, 128, 4
IN_PTS, IN_FEAT, IN_VIEWS = 63, 20, 3
N_FREQS = 10
BN_EPS, SLOPE = 1e-5, 0.01
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# FeatureNet: (name, cin, cout, kernel, stride)
FEATURE_CONVS = [("conv0.0", 3, 8, 3, 1), ("conv0.1", 8, 8, 3, 1),
                 ("conv1.0", 8, 16, 5, 2), ("conv1.1", 16, 16, 3, 1),
                 ("conv1.2", 16, 16, 3, 1), ("conv2.0", 16, 32, 5, 2),
                 ("conv2.1", 32, 32, 3, 1), ("conv2.2", 32, 32, 3, 1)]
# CostRegNet's encoder: (name, cin, cout, stride); decoder: (name, cin, cout)
COSTREG_ENC = [("conv0", 41, 8, 1), ("conv1", 8, 16, 2), ("conv2", 16, 16, 1),
               ("conv3", 16, 32, 2), ("conv4", 32, 32, 1),
               ("conv5", 32, 64, 2), ("conv6", 64, 64, 1)]
COSTREG_DEC = [("conv7", 64, 32), ("conv9", 32, 16), ("conv11", 16, 8)]


def mlp_layers():
    """(name, in, out) of every linear layer of the v0 MLP."""
    dims = [IN_PTS] + [MLP_W + IN_PTS if i - 1 == SKIP else MLP_W
                       for i in range(1, MLP_D)]
    out = [(f"pts_linears.{i}", d, MLP_W) for i, d in enumerate(dims)]
    return out + [("pts_bias", IN_FEAT, MLP_W),
                  ("views_linears.0", IN_VIEWS + MLP_W, MLP_W // 2),
                  ("feature_linear", MLP_W, MLP_W),
                  ("alpha_linear", MLP_W, 1),
                  ("rgb_linear", MLP_W // 2, 3)]


def _bn(prefix, c):
    return [(f"{prefix}.weight", (c,)), (f"{prefix}.bias", (c,)),
            (f"{prefix}.running_mean", (c,)), (f"{prefix}.running_var", (c,)),
            (f"{prefix}.num_batches_tracked", ())]


def param_table():
    """{checkpoint entry: [(key, shape)]}, in a fixed order. Keys ending in
    running_mean, running_var and num_batches_tracked are buffers that
    nothing reads (batch statistics are always used)."""
    fn = []
    for name, din, dout in mlp_layers():
        fn += [(f"nerf.{name}.weight", (dout, din)),
               (f"nerf.{name}.bias", (dout,))]
    mvs = []
    for name, cin, cout, k, _ in FEATURE_CONVS:
        mvs += [(f"feature.{name}.conv.weight", (cout, cin, k, k))]
        mvs += _bn(f"feature.{name}.bn", cout)
    mvs += [("feature.toplayer.weight", (32, 32, 1, 1)),
            ("feature.toplayer.bias", (32,))]
    for name, cin, cout, _ in COSTREG_ENC:
        mvs += [(f"cost_reg_2.{name}.conv.weight", (cout, cin, 3, 3, 3))]
        mvs += _bn(f"cost_reg_2.{name}.bn", cout)
    for name, cin, cout in COSTREG_DEC:
        mvs += [(f"cost_reg_2.{name}.0.weight", (cin, cout, 3, 3, 3))]
        mvs += _bn(f"cost_reg_2.{name}.1", cout)
    return {"network_fn_state_dict": fn, "network_mvs_state_dict": mvs}


def trainable(key: str) -> bool:
    return not key.endswith(("running_mean", "running_var",
                             "num_batches_tracked"))


# ------------------------------------------------------------- MVSNet ---

def _abn(x, p, prefix):
    y = F.batch_norm(x, None, None, p[prefix + ".weight"],
                     p[prefix + ".bias"], training=True, eps=BN_EPS)
    return F.leaky_relu(y, SLOPE)


def feature_net(p, imgs):
    """(V, H, W, 3) normalised images -> (V, H/4, W/4, 32)."""
    x = imgs.permute(0, 3, 1, 2)
    for name, _, _, k, stride in FEATURE_CONVS:
        x = F.conv2d(x, p[f"feature.{name}.conv.weight"], stride=stride,
                     padding=k // 2)
        x = _abn(x, p, f"feature.{name}.bn")
    x = F.conv2d(x, p["feature.toplayer.weight"], p["feature.toplayer.bias"])
    return x.permute(0, 2, 3, 1)


def depth_planes(near, far, n: int):
    t = torch.linspace(0.0, 1.0, n, device=near.device)
    return near * (1.0 - t) + far * t


# The in-image masks below are steps: a point a rounding error from an
# image's edge counts in one computation and not in another. So the
# coordinates they test are computed in one fixed order of correctly
# rounded operations (no matrix product, divisions by tensors), the
# order the authors' formulas are written in.

def _sweep_coords(proj, depths, xs, ys):
    """Source-pixel (x, y), each (D, n), of reference pixels (xs, ys) on
    the planes: [R | T] applied as R @ [x, y, 1] + T / d, then divided."""
    src = [((proj[i, 0] * xs + proj[i, 1] * ys) + proj[i, 2])[None]
           + (proj[i, 3] / depths)[:, None] for i in range(3)]
    inv_z = 1.0 / src[2]
    return src[0] * inv_z, src[1] * inv_z


def cost_volume(imgs, feats, proj_mats, depths, pad: int):
    """The variance cost volume (models.py build_volume_costvar_img), NCDHW
    (1, 3V + C, D, h + 2 pad, w + 2 pad): [ref RGB | warped source RGB |
    variance of the features], zeros outside a view, the variance over the
    views that see each voxel (the reference view always counts)."""
    V, h, w, C = feats.shape
    D = depths.shape[0]
    hp, wp = h + 2 * pad, w + 2 * pad
    small = F.interpolate(imgs.permute(0, 3, 1, 2), size=(h, w),
                          mode="bilinear", align_corners=False)
    srcs = torch.cat([feats.permute(0, 3, 1, 2), small], 1)  # (V, C+3, h, w)
    ref = F.pad(srcs[0], (pad, pad, pad, pad))               # (C+3, hp, wp)
    vsum = ref[:C].unsqueeze(1).expand(C, D, hp, wp)
    vsq = vsum ** 2
    count = torch.ones((D, hp, wp), device=imgs.device)
    rgb = [ref[C:].unsqueeze(1).expand(3, D, hp, wp)]
    ys, xs = torch.meshgrid(
        torch.arange(hp, dtype=torch.float32, device=imgs.device) - pad,
        torch.arange(wp, dtype=torch.float32, device=imgs.device) - pad,
        indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    half_w = torch.tensor((w - 1) / 2.0, device=imgs.device)
    half_h = torch.tensor((h - 1) / 2.0, device=imgs.device)
    for v in range(1, V):
        x, y = _sweep_coords(proj_mats[v], depths, xs, ys)
        grid = torch.stack([x / half_w - 1, y / half_h - 1], -1)
        warped = F.grid_sample(srcs[v:v + 1], grid.reshape(1, D, hp * wp, 2),
                               mode="bilinear", padding_mode="zeros",
                               align_corners=True)[0].reshape(C + 3, D, hp, wp)
        vsum = vsum + warped[:C]
        vsq = vsq + warped[:C] ** 2
        rgb.append(warped[C:])
        inside = (x > 0) & (x < w - 1) & (y > 0) & (y < h - 1)
        count = count + inside.float().reshape(D, hp, wp)
    inv = 1.0 / count
    var = vsq * inv - (vsum * inv) ** 2
    return torch.cat(rgb + [var], 0)[None]


def cost_reg(p, x):
    """The 3-D U-Net, (1, 41, D, H, W) -> (1, 8, D, H, W); sizes padded up
    to a multiple of 8 and cropped back."""
    d0, h0, w0 = x.shape[2:]
    pads = [(-s) % 8 for s in (d0, h0, w0)]
    x = F.pad(x, (0, pads[2], 0, pads[1], 0, pads[0]))
    skips = {}
    y = x
    for name, _, _, stride in COSTREG_ENC:
        y = F.conv3d(y, p[f"cost_reg_2.{name}.conv.weight"], stride=stride,
                     padding=1)
        y = _abn(y, p, f"cost_reg_2.{name}.bn")
        skips[name] = y
    for (name, _, _), skip in zip(COSTREG_DEC, ("conv4", "conv2", "conv0")):
        up = F.conv_transpose3d(y, p[f"cost_reg_2.{name}.0.weight"],
                                stride=2, padding=1, output_padding=1)
        y = skips[skip] + _abn(up, p, f"cost_reg_2.{name}.1")
    return y[:, :, :d0, :h0, :w0]


def encoding_volume(p, imgs_norm, proj_mats, near_far, pad: int,
                    n_planes: int = 128):
    """MVSNet: (V, H, W, 3) normalised views -> (D, hp, wp, 8)."""
    feats = feature_net(p, imgs_norm)
    depths = depth_planes(near_far[0], near_far[1], n_planes)
    cost = cost_volume(imgs_norm, feats, proj_mats, depths, pad)
    return cost_reg(p, cost)[0].permute(1, 2, 3, 0)


def unpreprocess(imgs_norm):
    mean = torch.tensor(IMAGENET_MEAN, device=imgs_norm.device)
    std = torch.tensor(IMAGENET_STD, device=imgs_norm.device)
    return imgs_norm * std + mean


# ---------------------------------------------------------- rendering ---

def stratified(near, far, n_rays: int, n_samples: int, u=None):
    """(n_rays, n_samples) depths from near to far, jittered within their
    bins by uniforms `u` when given."""
    t = torch.linspace(0.0, 1.0, n_samples, device=near.device)
    z = (near * (1.0 - t) + far * t).expand(n_rays, n_samples)
    if u is None:
        return z
    mids = 0.5 * (z[:, :-1] + z[:, 1:])
    upper = torch.cat([mids, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mids], -1)
    return lower + (upper - lower) * u


def ref_ndc(pts, w2c_ref, k_ref, img_hw, near_far, pad: int):
    """World points -> the padded volume's [0, 1] coordinates (x, y, z)."""
    cam = pts @ w2c_ref[:3, :3].T + w2c_ref[:3, 3]
    pix = cam @ k_ref.T
    scale = torch.tensor([img_hw[1] - 1.0, img_hw[0] - 1.0],
                         device=pts.device)
    xy = pix[..., :2] / pix[..., 2:3] / scale
    z = (pix[..., 2] - near_far[0]) / (near_far[1] - near_far[0])
    wh_feat = (scale + 1.0) / 4.0
    xy = xy * wh_feat / (wh_feat + 2 * pad) + pad / (wh_feat + 2 * pad)
    return torch.cat([xy, z[..., None]], -1)


def fetch_volume(volume, ndc):
    """Trilinear, zeros outside: (D, H, W, C) at (..., 3) -> (..., C)."""
    C = volume.shape[-1]
    grid = (ndc * 2.0 - 1.0).reshape(1, -1, 1, 1, 3)
    out = F.grid_sample(volume.permute(3, 0, 1, 2)[None], grid,
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out[0, :, :, 0, 0].T.reshape(*ndc.shape[:-1], C)


def source_colors(pts, w2cs, intrinsics, imgs):
    """Each source view's RGB (bilinear, border) and in-image mask at the
    points: (..., 4V) in per-view blocks [R, G, B, mask]."""
    V, H, W, _ = imgs.shape
    wm1 = torch.tensor(W - 1.0, device=pts.device)
    hm1 = torch.tensor(H - 1.0, device=pts.device)
    p0, p1, p2 = pts.unbind(-1)
    parts = []
    for v in range(V):
        E, K = w2cs[v], intrinsics[v]
        c = [((p0 * E[i, 0] + p1 * E[i, 1]) + p2 * E[i, 2]) + E[i, 3]
             for i in range(3)]
        q = [(c[0] * K[i, 0] + c[1] * K[i, 1]) + c[2] * K[i, 2]
             for i in range(3)]
        gx = q[0] / q[2] / wm1 * 2 - 1
        gy = q[1] / q[2] / hm1 * 2 - 1
        grid = torch.stack([gx, gy], -1)
        rgb = F.grid_sample(imgs[v].permute(2, 0, 1)[None],
                            grid.reshape(1, -1, 1, 2), mode="bilinear",
                            padding_mode="border", align_corners=True)
        parts.append(rgb[0, :, :, 0].T.reshape(*pts.shape[:-1], 3))
        inside = (gx > -1) & (gx < 1) & (gy > -1) & (gy < 1)
        parts.append(inside.float()[..., None])
    return torch.cat(parts, -1)


def positional_encoding(x, n_freqs: int = N_FREQS):
    freqs = 2.0 ** torch.linspace(0.0, n_freqs - 1, n_freqs, device=x.device)
    scaled = (x[..., None, :] * freqs[:, None]).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(scaled), torch.cos(scaled)], -1)


def mlp_v0(p, x):
    """(..., 86) [PE | features | view dirs] -> (..., 4) [rgb | sigma]."""
    def lin(name, h):
        return F.linear(h, p[f"nerf.{name}.weight"], p[f"nerf.{name}.bias"])

    pts, feat, views = torch.split(x, [IN_PTS, IN_FEAT, IN_VIEWS], -1)
    bias = lin("pts_bias", feat)
    h = pts
    for i in range(MLP_D):
        h = torch.relu(lin(f"pts_linears.{i}", h) * bias)
        if i == SKIP:
            h = torch.cat([pts, h], -1)
    sigma = torch.relu(lin("alpha_linear", h))
    hv = torch.relu(lin("views_linears.0",
                        torch.cat([lin("feature_linear", h), views], -1)))
    return torch.cat([torch.sigmoid(lin("rgb_linear", hv)), sigma], -1)


def composite(raw, z_vals):
    alpha = 1.0 - torch.exp(-raw[..., 3])
    ones = torch.ones_like(alpha[:, :1])
    trans = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], -1),
                          -1)[:, :-1]
    weights = alpha * trans
    return {"rgb": (weights[..., None] * raw[..., :3]).sum(1),
            "depth": (weights * z_vals).sum(1), "acc": weights.sum(1)}


def render_rays(p, volume, rays, scene, u=None):
    """Render (N, 8) [origin, direction, near, far] rays over `volume`.

    scene: dict with `imgs` (V, H, W, 3) in [0, 1], `w2cs` (V, 4, 4),
    `intrinsics` (V, 3, 3) image-scale, `near_far` (2,) of the sources,
    `pad`; `u` the (N, S) jitter or None. The samples per ray are u's
    width, else scene["n_samples"]. Returns rgb (N, 3), depth, acc (N,).
    """
    n = rays.shape[0]
    s = u.shape[1] if u is not None else scene["n_samples"]
    rays_o, rays_d = rays[:, :3], rays[:, 3:6]
    z = stratified(rays[:, 6:7], rays[:, 7:8], n, s, u)
    pts = rays_o[:, None] + rays_d[:, None] * z[..., None]
    w2cs, ks, imgs = scene["w2cs"], scene["intrinsics"], scene["imgs"]
    ndc = ref_ndc(pts, w2cs[0], ks[0], imgs.shape[1:3], scene["near_far"],
                  scene["pad"])
    feats = torch.cat([fetch_volume(volume, ndc),
                       source_colors(pts, w2cs, ks, imgs)], -1)
    unit = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    dirs = (unit @ w2cs[0][:3, :3].T)[:, None].expand(n, s, 3)
    x = torch.cat([positional_encoding(ndc), feats, dirs], -1)
    return composite(mlp_v0(p, x), z)


@torch.no_grad()
def render_image(p, volume, rays, scene, block: int = 4096, u_fn=None):
    """`render_rays` over a full buffer in blocks of `block` rays;
    `u_fn(n)` gives each block's jitter in order (None: unjittered)."""
    outs = []
    for i in range(0, rays.shape[0], block):
        r = rays[i:i + block]
        outs.append(render_rays(p, volume, r, scene,
                                None if u_fn is None else u_fn(r.shape[0])))
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def mse(pred, target):
    return torch.mean((pred - target) ** 2)


def cosine_lr(lrate: float, count: int, num_steps: int,
              eta_min: float = 1e-7) -> float:
    """Cosine decay from lrate to eta_min over num_steps
    (train_mvs_nerf_pl.py CosineAnnealingLR)."""
    t = min(count, num_steps)
    return eta_min + (lrate - eta_min) * 0.5 * (1 + math.cos(
        math.pi * t / num_steps))

"""Plain PyTorch MVSNeRF with the v1 attention MLP (`--net_type v1`): the
benchmark's reference for the `dtu_v1` configuration.

Written from the authors' code (apchenstu/mvsnerf: models.py:304-462
`Renderer_attention`, models.py:70-141 `MultiHeadAttention`, opt.py
`--net_type`). MVSNet, the sampling, the colours and the compositing are
`mvsnerf_v0`'s, which this module re-exports; only the MLP differs. It
imports torch alone, and float32 with TF32 off unless a caller turns TF32
on (the precision control).

The v1 MLP, per sample: the three source views give three tokens of 12,
[RGB, mask | the volume's 8 channels]; a residual 4-head attention over
them (d_model 12, d_k = d_v = 4, no bias on q, k, v or fc, a LayerNorm
with eps 1e-6 after the residual); `sigmoid(weight_out(.))` of each token
summed over the views is the sample's colour; `pts_bias` over [volume |
colour] (11 -> 128) is ADDED at every layer of a 6 x 128 ReLU trunk over
the PE, with no skip; the v0 view-direction head. The authors' MLP returns
the colour twice after RGB and sigma; the render reads RGB and sigma.

Parameters are one dict of tensors under the authors' checkpoint keys;
`param_table` lists them, the LayerNorm's scale and shift marked as a
norm's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import NORM
from .mvsnerf_v0 import (IN_PTS, IN_VIEWS, MLP_D, MLP_W,  # noqa: F401
                         composite, cosine_lr, cost_reg, cost_volume,
                         depth_planes, encoding_volume, feature_net,
                         fetch_volume, mse, positional_encoding, ref_ndc,
                         source_colors, stratified, trainable,
                         unpreprocess)
from .mvsnerf_v0 import param_table as _v0_param_table

N_HEAD, D_MODEL, D_K = 4, 12, 4
LN_EPS = 1e-6


def mlp_layers():
    """(name, in, out, bias) of every linear layer of the v1 MLP."""
    out = [("pts_linears.0", IN_PTS, MLP_W, True)]
    out += [(f"pts_linears.{i}", MLP_W, MLP_W, True)
            for i in range(1, MLP_D)]
    return out + [("pts_bias", 8 + 3, MLP_W, True),
                  ("views_linears.0", IN_VIEWS + MLP_W, MLP_W // 2, True),
                  ("feature_linear", MLP_W, MLP_W, True),
                  ("alpha_linear", MLP_W, 1, True),
                  ("rgb_linear", MLP_W // 2, 3, True),
                  ("color_attention.w_qs", D_MODEL, N_HEAD * D_K, False),
                  ("color_attention.w_ks", D_MODEL, N_HEAD * D_K, False),
                  ("color_attention.w_vs", D_MODEL, N_HEAD * D_K, False),
                  ("color_attention.fc", N_HEAD * D_K, D_MODEL, False),
                  ("weight_out", D_MODEL, 3, True)]


def param_table():
    """{checkpoint entry: [(key, shape) or (key, shape, NORM)]}, in a fixed
    order: the v1 MLP's, then `mvsnerf_v0`'s MVSNet."""
    fn = []
    for name, din, dout, bias in mlp_layers():
        fn.append((f"nerf.{name}.weight", (dout, din)))
        if bias:
            fn.append((f"nerf.{name}.bias", (dout,)))
    fn += [("nerf.color_attention.layer_norm.weight", (D_MODEL,), NORM),
           ("nerf.color_attention.layer_norm.bias", (D_MODEL,), NORM)]
    return {"network_fn_state_dict": fn,
            "network_mvs_state_dict":
                _v0_param_table()["network_mvs_state_dict"]}


def color_attention(p, feat):
    """(..., 20) [volume 8 | 3 x (RGB, mask)] -> (..., 3), the colour."""
    def w(name):
        return p[f"nerf.color_attention.{name}.weight"]

    lead = feat.shape[:-1]
    n_views = (feat.shape[-1] - 8) // 4
    cm = feat[..., 8:].reshape(-1, n_views, 4)
    vol = feat[..., :8].reshape(-1, 1, 8).expand(-1, n_views, 8)
    tok = torch.cat([cm, vol], -1)                      # (B, V, 12)
    B = tok.shape[0]

    def heads(x):
        return x.view(B, n_views, N_HEAD, D_K).transpose(1, 2)

    q, k, v = (heads(F.linear(tok, w(n))) for n in ("w_qs", "w_ks", "w_vs"))
    att = torch.softmax((q / D_K ** 0.5) @ k.transpose(2, 3), -1)
    o = (att @ v).transpose(1, 2).reshape(B, n_views, N_HEAD * D_K)
    y = F.layer_norm(F.linear(o, w("fc")) + tok, (D_MODEL,),
                     w("layer_norm"),
                     p["nerf.color_attention.layer_norm.bias"], LN_EPS)
    rgb = torch.sigmoid(F.linear(y, p["nerf.weight_out.weight"],
                                 p["nerf.weight_out.bias"]))
    return rgb.sum(-2).reshape(*lead, 3)


def mlp_v1(p, x):
    """(..., 86) [PE | features | view dirs] -> (..., 4) [rgb | sigma]."""
    def lin(name, h):
        return F.linear(h, p[f"nerf.{name}.weight"], p[f"nerf.{name}.bias"])

    pts, feat, views = torch.split(x, [IN_PTS, 20, IN_VIEWS], -1)
    color = color_attention(p, feat)
    bias = lin("pts_bias", torch.cat([feat[..., :8], color], -1))
    h = pts
    for i in range(MLP_D):
        h = torch.relu(lin(f"pts_linears.{i}", h) + bias)
    sigma = torch.relu(lin("alpha_linear", h))
    hv = torch.relu(lin("views_linears.0",
                        torch.cat([lin("feature_linear", h), views], -1)))
    return torch.cat([torch.sigmoid(lin("rgb_linear", hv)), sigma], -1)


def render_rays(p, volume, rays, scene, u=None):
    """`mvsnerf_v0.render_rays` with the v1 MLP: (N, 8) [origin,
    direction, near, far] rays over `volume` -> rgb (N, 3), depth, acc
    (N,)."""
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
    return composite(mlp_v1(p, x), z)


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

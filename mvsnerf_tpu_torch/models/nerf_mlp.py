"""The NeRF MLPs (`--net_type` v0, v1, v2 and fusion), counterparts of
mvsnerf_tpu/models/nerf_mlp.py (reference models.py:145-567).

    v0 (RendererOurs, `Renderer_ours`):
        bias = pts_bias(feat)
        h = relu(pts_linears[i](h) * bias)     multiplicative; [pe | h]
                                               after each layer in `skips`
        alpha = relu(alpha_linear(h))
        rgb = sigmoid(rgb_linear(relu(views_linears[0]([feature_linear(h) |
                                                        viewdirs]))))
    v2 (RendererLinear, `Renderer_linear`): v0 with an additive bias; its
        `forward_alpha` has no ReLU (JAX :83-99).
    v1 (RendererAttention, `Renderer_attention`): additive bias, no skip;
        the colour is fused by attention over the per-view (RGB, mask)
        tokens and joins the volume's 8 channels in the bias; the output
        appends that colour twice, (..., 10) (JAX :102-137). It has no
        alpha head (JAX `_ALPHA` has no v1).
    fusion (RendererColorFusion, `Renderer_color_fusion`): the v0 trunk,
        then attention along the 3 source views for the colour (JAX
        :140-175); its heads are `Sequential`s (keys `*.0.weight`).

Input layout x = [PE(xyz_ndc) (63) | features (20) | viewdirs (3)];
`forward_alpha` takes x without the viewdirs and returns alpha alone.
State-dict keys are the reference's network_fn_state_dict keys (`nerf.*`);
v0 and v2 share keys and shapes, so the caller names the type
(io/torch_ckpt.py). Only v0 at D=6, W=128 with skips (4,) runs on the
hand-written kernels K6, K7 and K8 (`MVSNeRF.runs_v0_kernels`); every
other type or shape runs these modules, as JAX's kernels are v0-only too.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import MultiHeadAttention

# the mvsnerf-v0 checkpoint's shape (create_nerf_mvs defaults)
D, W, IN_PTS, IN_FEAT, IN_VIEWS, SKIPS = 6, 128, 63, 20, 3, (4,)


def _trunk_dims(depth, width, skips, in_ch_pts):
    """Input widths of the trunk's layers: [pe | h] after a skip."""
    return [in_ch_pts] + [width + in_ch_pts if i - 1 in skips else width
                          for i in range(1, depth)]


class _Renderer(nn.Module):
    """What every MLP shares: the input split, the trunk (bias
    multiplicative or additive), the view-direction head and the alpha
    trunk."""

    MULTIPLICATIVE = True

    def __init__(self, skips, in_ch_pts, in_ch_views):
        super().__init__()
        self.skips, self.in_ch_pts, self.in_ch_views = tuple(skips), \
            in_ch_pts, in_ch_views

    def _split(self, x):
        n_feat = x.shape[-1] - self.in_ch_pts - self.in_ch_views
        return torch.split(x, [self.in_ch_pts, n_feat, self.in_ch_views],
                           dim=-1)

    def _trunk(self, input_pts, bias, apply_skip: bool = True):
        h = input_pts
        for i, lin in enumerate(self.pts_linears):
            h = lin(h)
            h = torch.relu(h * bias if self.MULTIPLICATIVE else h + bias)
            if apply_skip and i in self.skips:
                h = torch.cat([input_pts, h], dim=-1)
        return h

    def _head(self, h, input_views):
        """[rgb | relu(alpha)] from the trunk (models.py:208-218)."""
        alpha = torch.relu(self.alpha_linear(h))
        h = torch.cat([self.feature_linear(h), input_views], dim=-1)
        for lin in self.views_linears:
            h = torch.relu(lin(h))
        return torch.cat([torch.sigmoid(self.rgb_linear(h)), alpha], dim=-1)

    def _alpha_trunk(self, x):
        input_pts, input_feats = torch.split(
            x, [self.in_ch_pts, x.shape[-1] - self.in_ch_pts], dim=-1)
        return self._trunk(input_pts, self.pts_bias(input_feats))


class RendererOurs(_Renderer):
    """v0 MLP: multiplicative bias, `skips` concatenate the PE back in."""

    def __init__(self, D: int = D, W: int = W, skips=SKIPS,
                 in_ch_pts: int = IN_PTS, in_ch_views: int = IN_VIEWS,
                 in_ch_feat: int = IN_FEAT, device=None):
        super().__init__(skips, in_ch_pts, in_ch_views)
        self.pts_linears = nn.ModuleList(
            [nn.Linear(d, W, device=device)
             for d in _trunk_dims(D, W, self.skips, in_ch_pts)])
        self.pts_bias = nn.Linear(in_ch_feat, W, device=device)
        self.views_linears = nn.ModuleList(
            [nn.Linear(in_ch_views + W, W // 2, device=device)])
        self.feature_linear = nn.Linear(W, W, device=device)
        self.alpha_linear = nn.Linear(W, 1, device=device)
        self.rgb_linear = nn.Linear(W // 2, 3, device=device)

    def forward_alpha(self, x):
        """x (..., 63 + 20) -> (..., 1) alpha (reference models.py:176-191,
        JAX `mlp_v0_alpha`)."""
        return torch.relu(self.alpha_linear(self._alpha_trunk(x)))

    def forward(self, x):
        """x (..., 63 + 20 + 3) -> (..., 4) RGBA."""
        input_pts, input_feats, input_views = self._split(x)
        h = self._trunk(input_pts, self.pts_bias(input_feats))
        return self._head(h, input_views)


class RendererLinear(RendererOurs):
    """v2 MLP: v0 with an additive bias (JAX `mlp_v2_apply`)."""

    MULTIPLICATIVE = False

    def forward_alpha(self, x):
        """No ReLU on the alpha head (reference models.py:495-508, JAX
        `mlp_v2_alpha`)."""
        return self.alpha_linear(self._alpha_trunk(x))


class RendererAttention(_Renderer):
    """v1 MLP: additive bias over [volume (8) | attention colour (3)], no
    skip (JAX `mlp_v1_apply`)."""

    MULTIPLICATIVE = False

    def __init__(self, D: int = D, W: int = W, skips=SKIPS,
                 in_ch_pts: int = IN_PTS, in_ch_views: int = IN_VIEWS,
                 in_ch_feat: int = IN_FEAT, device=None):
        super().__init__(skips, in_ch_pts, in_ch_views)
        self.pts_linears = nn.ModuleList(
            [nn.Linear(in_ch_pts, W, device=device)] +
            [nn.Linear(W, W, device=device) for _ in range(D - 1)])
        self.pts_bias = nn.Linear(11, W, device=device)
        self.views_linears = nn.ModuleList(
            [nn.Linear(in_ch_views + W, W // 2, device=device)])
        self.feature_linear = nn.Linear(W, W, device=device)
        self.alpha_linear = nn.Linear(W, 1, device=device)
        self.rgb_linear = nn.Linear(W // 2, 3, device=device)
        self.color_attention = MultiHeadAttention(4, 12, 4, 4, device=device)
        self.weight_out = nn.Linear(12, 3, device=device)

    def _color(self, input_feats):
        """The colour fused over the per-view (RGB, mask) tokens, each
        joined to the volume's 8 channels (models.py:426-436)."""
        lead = input_feats.shape[:-1]
        n_views = (input_feats.shape[-1] - 8) // 4
        colors = input_feats[..., 8:].reshape(-1, n_views, 4)
        vol8 = input_feats[..., :8].reshape(-1, 1, 8).expand(-1, n_views, 8)
        tokens = torch.cat([colors, vol8], dim=-1)
        out, _ = self.color_attention(tokens, tokens, tokens)
        fused = torch.sigmoid(self.weight_out(out)).sum(dim=-2)
        return fused.reshape(*lead, 3)

    def forward_alpha(self, x):
        raise NotImplementedError(
            "the v1 MLP (Renderer_attention) has no alpha head: JAX's "
            "mlp_apply_alpha has no v1 (mvsnerf_tpu/models/nerf_mlp.py:222)")

    def forward(self, x):
        """x (..., 63 + 20 + 3) -> (..., 10): [rgb, alpha, colour, colour]
        (the reference appends the colour twice, models.py:458 and 461)."""
        input_pts, input_feats, input_views = self._split(x)
        colors = self._color(input_feats) if input_feats.shape[-1] > 11 \
            else input_feats[..., -3:]
        bias = self.pts_bias(torch.cat([input_feats[..., :8], colors], -1))
        h = self._trunk(input_pts, bias, apply_skip=False)
        return torch.cat([self._head(h, input_views), colors, colors], -1)


class RendererColorFusion(_Renderer):
    """fusion MLP: the v0 trunk and alpha head; the colour by attention
    over the 3 source views' [feature (16) | view dir | RGB] tokens, masked
    by their in-image masks (JAX `mlp_fusion_apply`)."""

    def __init__(self, D: int = D, W: int = W, skips=SKIPS,
                 in_ch_pts: int = IN_PTS, in_ch_views: int = IN_VIEWS,
                 in_ch_feat: int = IN_FEAT, device=None):
        super().__init__(skips, in_ch_pts, in_ch_views)
        attn_dim = 16 + 3 + in_ch_views // 3
        self.pts_linears = nn.ModuleList(
            [nn.Linear(d, W, device=device)
             for d in _trunk_dims(D, W, self.skips, in_ch_pts)])
        self.pts_bias = nn.Linear(in_ch_feat, W, device=device)
        self.feature_linear = nn.Sequential(
            nn.Linear(W, 16, device=device), nn.ReLU())
        self.alpha_linear = nn.Sequential(
            nn.Linear(W, 1, device=device), nn.ReLU())
        self.rgb_out = nn.Sequential(
            nn.Linear(attn_dim, 3, device=device), nn.Sigmoid())
        self.ray_attention = MultiHeadAttention(4, attn_dim, 4, 4,
                                                device=device)

    def forward_alpha(self, x):
        """relu(alpha_linear(h)): the ReLU is the head's own (reference
        models.py:258-270, JAX `mlp_fusion_alpha`)."""
        return self.alpha_linear(self._alpha_trunk(x))

    def forward(self, x):
        """x (..., 63 + 20 + 3) -> (..., 4) RGBA."""
        input_pts, input_feats, input_views = self._split(x)
        h = self._trunk(input_pts, self.pts_bias(input_feats))
        alpha = self.alpha_linear(h)
        views = input_views.reshape(-1, 3, self.in_ch_views // 3)
        rgbm = input_feats[..., 8:].reshape(-1, 3, 4)
        feature = self.feature_linear(h)
        ftok = feature.reshape(-1, 1, feature.shape[-1]).expand(-1, 3, -1)
        tokens = torch.cat([ftok, views, rgbm[..., :3]], dim=-1)
        out, _ = self.ray_attention(tokens, tokens, tokens,
                                    mask=rgbm[..., 3:])
        rgb = self.rgb_out(out).sum(dim=1).reshape(*alpha.shape[:-1], 3)
        return torch.cat([rgb, alpha], dim=-1)


RENDERERS = {"v0": RendererOurs, "v1": RendererAttention,
             "v2": RendererLinear, "fusion": RendererColorFusion}


class MVSNeRF(nn.Module):
    """The reference's network_fn wrapper: the MLP of `net_type` (depth D,
    width W) lives under `nerf`."""

    def __init__(self, net_type: str = "v0", D: int = D, W: int = W,
                 device=None):
        super().__init__()
        if net_type not in RENDERERS:
            raise ValueError(f"--net_type {net_type!r}: one of "
                             f"{sorted(RENDERERS)}")
        self.net_type, self.D, self.W = net_type, D, W
        self.nerf = RENDERERS[net_type](D=D, W=W, device=device)

    @property
    def runs_v0_kernels(self) -> bool:
        """Whether K6, K7 and K8 can take this MLP: v0 at the reference
        checkpoint's shape (D=6, W=128, skips (4,))."""
        return self.net_type == "v0" and self.D == D and self.W == W and \
            self.nerf.skips == SKIPS

    def forward(self, x):
        return self.nerf(x)

    def forward_alpha(self, x):
        return self.nerf.forward_alpha(x)

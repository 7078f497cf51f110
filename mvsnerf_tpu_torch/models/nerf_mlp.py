"""The v0 NeRF MLP (`Renderer_ours`), counterpart of
mvsnerf_tpu/models/nerf_mlp.py `mlp_v0_apply`.

    bias = pts_bias(feat)                      20 -> 128
    h = relu(pts_linears[i](h) * bias)         multiplicative, 6 x 128,
                                               input [pe | h] after layer 4
    alpha = relu(alpha_linear(h))
    rgb = sigmoid(rgb_linear(relu(views_linears[0]([feature_linear(h) |
                                                    viewdirs]))))

Input layout x = [PE(xyz_ndc) (63) | features (20) | viewdirs (3)].
State-dict keys are the reference's network_fn_state_dict keys (`nerf.*`).
"""

from __future__ import annotations

import torch
import torch.nn as nn


# the mvsnerf-v0 checkpoint's shape (create_nerf_mvs defaults)
D, W, IN_PTS, IN_FEAT, IN_VIEWS, SKIP = 6, 128, 63, 20, 3, 4


class RendererOurs(nn.Module):
    """v0 MLP: W=128, D=6, skip after layer 4."""

    def __init__(self, device=None):
        super().__init__()
        dims = [IN_PTS] + [W + IN_PTS if i - 1 == SKIP else W
                           for i in range(1, D)]
        self.pts_linears = nn.ModuleList(
            [nn.Linear(d, W, device=device) for d in dims])
        self.pts_bias = nn.Linear(IN_FEAT, W, device=device)
        self.views_linears = nn.ModuleList(
            [nn.Linear(IN_VIEWS + W, W // 2, device=device)])
        self.feature_linear = nn.Linear(W, W, device=device)
        self.alpha_linear = nn.Linear(W, 1, device=device)
        self.rgb_linear = nn.Linear(W // 2, 3, device=device)

    def forward(self, x):
        """x (..., 63 + 20 + 3) -> (..., 4) RGBA."""
        input_pts, input_feats, input_views = torch.split(
            x, [IN_PTS, IN_FEAT, IN_VIEWS], dim=-1)
        bias = self.pts_bias(input_feats)
        h = input_pts
        for i, lin in enumerate(self.pts_linears):
            h = torch.relu(lin(h) * bias)
            if i == SKIP:
                h = torch.cat([input_pts, h], dim=-1)
        alpha = torch.relu(self.alpha_linear(h))
        h = torch.cat([self.feature_linear(h), input_views], dim=-1)
        for lin in self.views_linears:
            h = torch.relu(lin(h))
        rgb = torch.sigmoid(self.rgb_linear(h))
        return torch.cat([rgb, alpha], dim=-1)


class MVSNeRF(nn.Module):
    """The reference's network_fn wrapper: the MLP lives under `nerf`."""

    def __init__(self, device=None):
        super().__init__()
        self.nerf = RendererOurs(device=device)

    def forward(self, x):
        return self.nerf(x)

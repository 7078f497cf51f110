"""The encoding-volume builder: FeatureNet (2D CNN), CostRegNet (3D U-Net)
and the MVSNet plane-sweep pipeline.

Counterpart of mvsnerf_tpu/models/mvsnet.py with its dense layout. The
convolutions run on cuDNN (float32, TF32 off; see the package docstring);
the 3-D U-Net runs in NCDHW, the layout the sweep kernel writes. The TPU-only packed variants (featurenet_packed.py,
costreg_packed.py) have no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.homography import build_cost_volume
from .layers import ABN, ConvBnReLU, ConvBnReLU3D

N_DEPTH_PLANES = 128  # hardcoded in the reference (models.py:914)


class FeatureNet(nn.Module):
    """(B, H, W, 3) -> (B, H/4, W/4, 32) stride-4 features."""

    def __init__(self, device=None):
        super().__init__()
        self.conv0 = nn.Sequential(ConvBnReLU(3, 8, 3, 1, 1, device=device),
                                   ConvBnReLU(8, 8, 3, 1, 1, device=device))
        self.conv1 = nn.Sequential(ConvBnReLU(8, 16, 5, 2, 2, device=device),
                                   ConvBnReLU(16, 16, 3, 1, 1, device=device),
                                   ConvBnReLU(16, 16, 3, 1, 1, device=device))
        self.conv2 = nn.Sequential(ConvBnReLU(16, 32, 5, 2, 2, device=device),
                                   ConvBnReLU(32, 32, 3, 1, 1, device=device),
                                   ConvBnReLU(32, 32, 3, 1, 1, device=device))
        self.toplayer = nn.Conv2d(32, 32, 1, device=device)

    def forward(self, x):
        # (B, H, W, 3) viewed as NCHW is already channels_last in memory
        y = self.toplayer(self.conv2(self.conv1(self.conv0(
            x.permute(0, 3, 1, 2)))))
        return y.permute(0, 2, 3, 1)


class CostRegNet(nn.Module):
    """3-D U-Net: (1, Cin, D, H, W) -> (1, 8, D, H, W).

    The three stride-2 levels need D, H, W divisible by 8; other sizes are
    zero-padded up to the next multiple of 8 and cropped back, as the JAX
    `cost_reg_apply` does."""

    def __init__(self, in_channels: int = 41, device=None):
        super().__init__()
        kw = dict(device=device)
        self.conv0 = ConvBnReLU3D(in_channels, 8, **kw)
        self.conv1 = ConvBnReLU3D(8, 16, stride=2, **kw)
        self.conv2 = ConvBnReLU3D(16, 16, **kw)
        self.conv3 = ConvBnReLU3D(16, 32, stride=2, **kw)
        self.conv4 = ConvBnReLU3D(32, 32, **kw)
        self.conv5 = ConvBnReLU3D(32, 64, stride=2, **kw)
        self.conv6 = ConvBnReLU3D(64, 64, **kw)
        self.conv7 = self._up(64, 32, device)
        self.conv9 = self._up(32, 16, device)
        self.conv11 = self._up(16, 8, device)

    @staticmethod
    def _up(cin, cout, device):
        return nn.Sequential(
            nn.ConvTranspose3d(cin, cout, 3, padding=1, output_padding=1,
                               stride=2, bias=False, device=device),
            ABN(cout, device=device))

    def forward(self, x):
        d0, h0, w0 = x.shape[2:]
        pads = [(-s) % 8 for s in (d0, h0, w0)]
        if any(pads):
            x = F.pad(x, (0, pads[2], 0, pads[1], 0, pads[0]))
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        y = self.conv6(self.conv5(conv4))
        y = conv4 + self.conv7(y)
        y = conv2 + self.conv9(y)
        y = conv0 + self.conv11(y)
        # crop only what was padded: the backward of a slice, even a whole
        # one, fills a zero tensor and copies the gradient into it
        return y[:, :, :d0, :h0, :w0] if any(pads) else y


def depth_plane_values(near, far, n_planes: int = N_DEPTH_PLANES,
                       lindisp: bool = False, device=None):
    """Sweep-plane depths (models.py:915-920)."""
    t = torch.linspace(0.0, 1.0, n_planes, device=device)
    if lindisp:
        return 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    return near * (1.0 - t) + far * t


class MVSNet(nn.Module):
    """FeatureNet + plane sweep + CostRegNet; state-dict keys `feature.*`
    and `cost_reg_2.*` as in the reference's network_mvs_state_dict."""

    def __init__(self, device=None):
        super().__init__()
        self.feature = FeatureNet(device=device)
        self.cost_reg_2 = CostRegNet(41, device=device)

    def forward(self, imgs, proj_mats, near_far, pad: int = 0,
                n_planes: int = N_DEPTH_PLANES, lindisp: bool = False):
        """Build the neural encoding volume (mvsnet_apply, dense layout),
        differentiable in the parameters (through K2 on a card).

        Args:
            imgs: (V, H, W, 3) normalised source images, view 0 = reference.
            proj_mats: (V, 3, 4) stride-4-scale projections relative to
                view 0.
            near_far: (2,) reference-view depth range.
            pad: cost-volume padding in feature pixels.
            lindisp: sweep planes linear in disparity (`--use_disp`).
        Returns:
            volume (D, hp, wp, 8) channel-last, depth_values (D,).
        """
        feats = self.feature(imgs)
        depth_values = depth_plane_values(near_far[0], near_far[1], n_planes,
                                          lindisp, device=imgs.device)
        cost = build_cost_volume(imgs, feats, proj_mats, depth_values,
                                 pad=pad)
        # (D, hp, wp, 41) -> (1, 41, D, hp, wp): the sweep's contiguous
        # output itself, no copy
        volume = self.cost_reg_2(cost.permute(3, 0, 1, 2)[None])
        # squeeze, not [0]: a view both ways (select's backward would fill
        # and copy a 150 MB gradient at DTU size)
        return volume.squeeze(0).permute(1, 2, 3, 0).contiguous(), \
            depth_values

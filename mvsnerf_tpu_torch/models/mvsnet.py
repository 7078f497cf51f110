"""The encoding-volume builder: FeatureNet (2D CNN), CostRegNet (3D U-Net)
and the MVSNet plane-sweep pipeline.

Counterpart of mvsnerf_tpu/models/mvsnet.py with its dense layout. The
convolutions run on cuDNN (float32, TF32 off; see the package docstring),
except the U-Net's on the `dband` route, which run on the hand-written K10
kernels of ops/costreg_conv.py (the counterpart of JAX's
`cost_reg_dband_apply`). `--costreg_impl auto`, the default, takes that
route on a CUDA card and cuDNN elsewhere; `plain` forces cuDNN, `dband`
K10. The 3-D U-Net runs in NCDHW, the layout the sweep kernel writes. The
TPU-only packed variants (featurenet_packed.py, costreg_packed.py) have no
counterpart here: `packed` runs on cuDNN.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.costreg_conv import conv3d_s1, conv3d_s2, conv3d_up
from ..ops.homography import build_cost_volume
from ..utils.profiling import trace_context
from .layers import ABN, ConvBnReLU, ConvBnReLU3D

N_DEPTH_PLANES = 128  # hardcoded in the reference (models.py:914)
# --costreg_impl values: `dband` runs the U-Net's convolutions on K10,
# `plain` and `packed` on cuDNN, `auto` on the one `costreg_route` picks
COSTREG_IMPLS = ("auto", "plain", "packed", "dband")


def costreg_route(impl, device):
    """The route `impl` takes for a U-Net input on `device`: "auto" is
    "dband" on a CUDA card and "plain" elsewhere; the other values are
    their own route. On the card K10 takes what the sweep writes, a
    float32 (1, C, D, H, W) cost volume, and raises on anything else: a
    caller who wants cuDNN there names "plain"."""
    if impl not in COSTREG_IMPLS:
        raise ValueError(f"unknown costreg impl {impl!r}")
    if impl != "auto":
        return impl
    return "dband" if torch.device(device).type == "cuda" else "plain"


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
    `cost_reg_apply` does.

    `impl` is a `--costreg_impl` value: "dband" runs the ten convolutions
    on K10 (ops/costreg_conv.py; its kernels take float32 only, like JAX's
    route, and its CPU twins any float type), "plain" and "packed" on
    cuDNN, and "auto" on K10 for an input on a CUDA card and on cuDNN
    for any other (`costreg_route`, once a call). Both routes use the
    same parameters and modules, so the state dict is the same."""

    def __init__(self, in_channels: int = 41, device=None,
                 impl: str = "auto"):
        super().__init__()
        if impl not in COSTREG_IMPLS:
            raise ValueError(f"unknown costreg impl {impl!r}")
        self.impl = impl
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

    def forward(self, x, impl: str | None = None):
        """(1, Cin, D, H, W) -> (1, 8, D, H, W) on the module's route, or
        on `impl` when given."""
        dband = costreg_route(impl or self.impl, x.device) == "dband"
        d0, h0, w0 = x.shape[2:]
        pads = [(-s) % 8 for s in (d0, h0, w0)]
        if any(pads):
            x = F.pad(x, (0, pads[2], 0, pads[1], 0, pads[0]))

        def enc(block, y, conv):
            return block.bn(conv(y, block.conv.weight)) if dband else block(y)

        def dec(block, y):
            return block[1](conv3d_up(y, block[0].weight)) if dband \
                else block(y)

        conv0 = enc(self.conv0, x, conv3d_s1)
        conv2 = enc(self.conv2, enc(self.conv1, conv0, conv3d_s2), conv3d_s1)
        conv4 = enc(self.conv4, enc(self.conv3, conv2, conv3d_s2), conv3d_s1)
        y = enc(self.conv6, enc(self.conv5, conv4, conv3d_s2), conv3d_s1)
        y = conv4 + dec(self.conv7, y)
        y = conv2 + dec(self.conv9, y)
        y = conv0 + dec(self.conv11, y)
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

    def __init__(self, device=None, costreg_impl: str = "auto"):
        super().__init__()
        self.feature = FeatureNet(device=device)
        self.cost_reg_2 = CostRegNet(41, device=device, impl=costreg_impl)

    def forward(self, imgs, proj_mats, near_far, pad: int = 0,
                n_planes: int = N_DEPTH_PLANES, lindisp: bool = False,
                costreg_impl: str | None = None):
        """Build the neural encoding volume (mvsnet_apply, dense layout),
        differentiable in the parameters (through K2 on a card).

        Args:
            imgs: (V, H, W, 3) normalised source images, view 0 = reference.
            proj_mats: (V, 3, 4) stride-4-scale projections relative to
                view 0.
            near_far: (2,) reference-view depth range.
            pad: cost-volume padding in feature pixels.
            lindisp: sweep planes linear in disparity (`--use_disp`).
            costreg_impl: the U-Net's route for this call; None keeps the
                one the module was built with.
        Returns:
            volume (D, hp, wp, 8) channel-last, depth_values (D,).
        """
        with trace_context("mvsnet.features"):
            feats = self.feature(imgs)
        with trace_context("mvsnet.sweep"):
            depth_values = depth_plane_values(near_far[0], near_far[1],
                                              n_planes, lindisp,
                                              device=imgs.device)
            cost = build_cost_volume(imgs, feats, proj_mats, depth_values,
                                     pad=pad)
        # (D, hp, wp, 41) -> (1, 41, D, hp, wp): the sweep's contiguous
        # output itself, no copy
        route = {} if costreg_impl is None else {"impl": costreg_impl}
        with trace_context("mvsnet.costreg"):
            volume = self.cost_reg_2(cost.permute(3, 0, 1, 2)[None],
                                     **route)
        # squeeze, not [0]: a view both ways (select's backward would fill
        # and copy a 150 MB gradient at DTU size)
        return volume.squeeze(0).permute(1, 2, 3, 0).contiguous(), \
            depth_values

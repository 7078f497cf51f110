"""Convert the lpips VGG weights to the .npz that `eval.metrics.LPIPS`
reads (the port's copy of the JAX package's
scripts/convert_lpips_weights.py; both packages' LPIPS read one format).

The reference computes LPIPS with the `lpips` package's VGG16 network
(renderer.ipynb cells 1/11/23, inputs scaled to [-1, 1]). Nothing is
downloaded here; the weights come from one of two sources:

1. Raw torch checkpoint files (no lpips install needed):
       python -m mvsnerf_tpu_torch.convert_lpips_weights \\
           --out lpips_vgg.npz --vgg_pth vgg16-397923af.pth --lin_pth vgg.pth
   where vgg_pth is the torchvision VGG16 state_dict and lin_pth is the
   lpips repo's lpips/weights/v0.1/vgg.pth (lin0..lin4 1x1 conv weights).
2. The `lpips` package itself, where it is installed:
       python -m mvsnerf_tpu_torch.convert_lpips_weights --out lpips_vgg.npz

Output keys: conv{i}_kernel (HWIO) and conv{i}_bias for the 13 VGG
convolutions, lin{j} (C_j,) for the 5 LPIPS heads.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

# torchvision VGG16 `features` indices of the 13 convolutions
VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def from_lpips_package():
    """The arrays of the `lpips` package's VGG LPIPS network."""
    import lpips

    net = lpips.LPIPS(net="vgg")
    out = {}
    convs = [m for sl in (net.net.slice1, net.net.slice2, net.net.slice3,
                          net.net.slice4, net.net.slice5) for m in sl]
    ci = 0
    for m in convs:
        if isinstance(m, torch.nn.Conv2d):
            out[f"conv{ci}_kernel"] = \
                m.weight.detach().permute(2, 3, 1, 0).numpy()
            out[f"conv{ci}_bias"] = m.bias.detach().numpy()
            ci += 1
    if ci != 13:
        raise ValueError(f"expected 13 convolutions, found {ci}")
    for j, lin in enumerate([net.lin0, net.lin1, net.lin2, net.lin3,
                             net.lin4]):
        out[f"lin{j}"] = lin.model[1].weight.detach().numpy().reshape(-1)
    return out


def from_state_dicts(vgg_pth: str, lin_pth: str):
    """The arrays of a torchvision VGG16 state dict (`features.{idx}.*`)
    and the lpips heads' (`lin{j}.model.1.weight`, (1, C, 1, 1))."""
    vgg_sd = torch.load(vgg_pth, map_location="cpu")
    lin_sd = torch.load(lin_pth, map_location="cpu")
    out = {}
    for ci, idx in enumerate(VGG16_CONV_IDX):
        out[f"conv{ci}_kernel"] = \
            vgg_sd[f"features.{idx}.weight"].permute(2, 3, 1, 0).numpy()
        out[f"conv{ci}_bias"] = vgg_sd[f"features.{idx}.bias"].numpy()
    for j in range(5):
        out[f"lin{j}"] = lin_sd[f"lin{j}.model.1.weight"].numpy().reshape(-1)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="lpips_vgg.npz")
    ap.add_argument("--vgg_pth", default=None,
                    help="torchvision vgg16 state_dict .pth")
    ap.add_argument("--lin_pth", default=None,
                    help="lpips v0.1 vgg.pth (lin heads)")
    args = ap.parse_args(argv)

    if args.vgg_pth and args.lin_pth:
        out = from_state_dicts(args.vgg_pth, args.lin_pth)
    else:
        try:
            out = from_lpips_package()
        except ImportError:
            raise SystemExit(
                "lpips package not installed - pass --vgg_pth/--lin_pth "
                "checkpoint files instead")
    np.savez(args.out, **out)
    print(f"wrote {args.out}: 13 convs + 5 lin heads")
    return args.out


if __name__ == "__main__":
    main()

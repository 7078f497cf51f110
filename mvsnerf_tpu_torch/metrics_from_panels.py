"""Post-hoc PSNR/SSIM/LPIPS from saved result panels or image pairs
(counterpart of the JAX package's scripts/metrics_from_panels.py, with the
same flags, rows and JSON; reference renderer.ipynb cells 25-31: metric
loops that score previously rendered PNGs against ground truth without
rendering again).

Two input modes:

1. Panels written by the eval and validation loops ([gt | pred | ...]
   side by side, as the reference's `{scene}_{step}_{j}.png` dumps,
   cell 27 layout gt=[:, :W] pred=[:, W:2W]):
       python -m mvsnerf_tpu_torch.metrics_from_panels \\
           --panels 'results/exp/*.png' --width 640
2. Separate prediction and GT files matched in sorted order (cells 25/31
   layout):
       python -m mvsnerf_tpu_torch.metrics_from_panels \\
           --pred 'logs/lego_test/*.png' --gt 'runs_fine_tuning/lego/*.png'

`--crop 0.1` applies the Blender 80 % centre crop (cell 11);
`--lpips_weights` adds LPIPS when the converted VGG weights exist
(`convert_lpips_weights`). Prints per-image rows and the mean as JSON, and
returns {"per_image": rows, "mean": {...}}. The metrics run on the card
unless `--device cpu` is given, and raise with no card (`resolve_device`).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from . import resolve_device
from .eval.metrics import LPIPS, psnr, ssim


def load_image(path):
    """An image file as float32 (H, W, 3) RGB in [0, 1]."""
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def image_pairs(args):
    """[(name, gt, pred)] from `--panels` or `--pred` / `--gt`."""
    pairs = []
    if args.panels:
        for f in sorted(glob.glob(args.panels)):
            panel = load_image(f)
            w = args.width or panel.shape[1] // 3
            pairs.append((os.path.basename(f), panel[:, :w],
                          panel[:, w:2 * w]))
    elif args.pred and args.gt:
        preds = sorted(glob.glob(args.pred))
        gts = sorted(glob.glob(args.gt))
        if len(preds) != len(gts):
            raise SystemExit(f"{len(preds)} predictions vs {len(gts)} GT "
                             "files - globs must match 1:1")
        for p, g in zip(preds, gts):
            pairs.append((os.path.basename(p), load_image(g), load_image(p)))
    else:
        raise SystemExit("pass --panels GLOB or --pred GLOB --gt GLOB")
    if not pairs:
        raise SystemExit("no images matched")
    return pairs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--panels", default=None,
                    help="glob of [gt | pred | ...] panel PNGs")
    ap.add_argument("--width", type=int, default=None,
                    help="single-image width inside a panel (default: "
                         "panel_width // 3, the framework's 3-pane layout)")
    ap.add_argument("--pred", default=None, help="glob of prediction PNGs")
    ap.add_argument("--gt", default=None, help="glob of ground-truth PNGs")
    ap.add_argument("--crop", type=float, default=0.0,
                    help="center-crop margin fraction (0.1 = Blender 80%% "
                         "crop, renderer.ipynb cell 11)")
    ap.add_argument("--lpips_weights", default="lpips_vgg.npz")
    ap.add_argument("--out", default=None, help="write metrics JSON here")
    ap.add_argument("--device", default="cuda",
                    help="where the metrics run: cuda (default) or cpu")
    args = ap.parse_args(argv)

    pairs = image_pairs(args)
    device = resolve_device(args.device)
    lpips_fn = LPIPS(args.lpips_weights, device) \
        if os.path.exists(args.lpips_weights) else None

    rows = []
    for name, gt, pred in pairs:
        if args.crop:
            hc = int(gt.shape[0] * args.crop)
            wc = int(gt.shape[1] * args.crop)
            gt = gt[hc:-hc, wc:-wc]
            pred = pred[hc:-hc, wc:-wc]
        gt, pred = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in (gt, pred))
        row = {"file": name, "psnr": float(psnr(pred, gt)),
               "ssim": float(ssim(pred, gt))}
        if lpips_fn is not None:
            row["lpips"] = float(lpips_fn(pred * 2 - 1, gt * 2 - 1))
        rows.append(row)
        print(json.dumps(row))

    mean = {k: float(np.mean([r[k] for r in rows]))
            for k in rows[0] if k != "file"}
    out = {"per_image": rows, "mean": mean}
    print(json.dumps({"mean": mean}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()

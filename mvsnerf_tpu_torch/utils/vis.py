"""Visualisation helpers (counterpart of mvsnerf_tpu/utils/vis.py,
reference utils.py:24-65), numpy only: the jet colormap is written out
here, so nothing needs matplotlib."""

from __future__ import annotations

import numpy as np

# matplotlib's 'jet' segment data: (x, value) breakpoints per channel
_JET = {
    "red": ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
    "green": ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0),
              (0.91, 0.0), (1.0, 0.0)),
    "blue": ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)),
}
_N = 256  # entries of matplotlib's lookup table
_JET_LUT = np.stack([
    np.interp(np.linspace(0.0, 1.0, _N), *np.asarray(_JET[c]).T)
    for c in ("red", "green", "blue")], -1)


def jet(x):
    """matplotlib's `colormaps['jet'](x)[..., :3]` for x in [0, 1]: the
    256-entry table indexed by int(x * 256) in x's own float type, the top
    clipped to 255."""
    idx = np.clip((np.asarray(x) * _N).astype(np.int64), 0, _N - 1)
    return _JET_LUT[idx]


def to8b(x):
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


def visualize_depth(depth, minmax=None):
    """Depth map -> ((H, W, 3) float32 jet image, (min, max) used); the
    minimum is the smallest positive depth (reference utils.py:30-46)."""
    depth = np.nan_to_num(np.asarray(depth, np.float32))
    if minmax is None:
        mi = np.min(depth[depth > 0]) if np.any(depth > 0) else 0.0
        ma = np.max(depth)
    else:
        mi, ma = minmax
    x = np.clip((depth - mi) / (ma - mi + 1e-8), 0, 1)
    return jet(x).astype(np.float32), (mi, ma)


def write_png(path, img):
    """Write an (H, W, 3) [0, 1] image as an 8-bit PNG with PIL (imported
    here only; the card's machine has PIL, not imageio)."""
    from PIL import Image
    Image.fromarray(to8b(img)).save(path)


def panel(images, axis=1):
    """Concatenate same-height images into a [a | b | c] strip."""
    return np.concatenate([np.asarray(im) for im in images], axis=axis)

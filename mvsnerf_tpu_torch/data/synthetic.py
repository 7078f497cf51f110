"""Hermetic scenes in the Blender and LLFF datasets' on-disk formats, made
from a seed, for the tests and `chip_smoke.py` (no dataset is shipped):

- `write_blender_scene`: `transforms_train.json` with NeRF-synthetic's
  lego field of view and 100 frames on a sphere of radius 4 about the
  origin (Blender / OpenGL c2w, z up), and RGBA PNGs of random pixels
  whose alpha is a disc (opaque inside, a soft rim, clear outside) for
  the frames named;
- `write_llff_scene`: `images/` and `poses_bounds.npy` of 20 forward-facing
  cameras on a 5 x 4 grid, in LLFF's "down right back" layout with
  [H, W, focal] of a 4032x3024 phone capture, near bounds 1.5-2.0 and far
  bounds 12-16.

The directory's name picks the pair table's split (`lego`, `fern`, ...);
the loaders read only the frames the split names. PIL is imported by the
writers only."""

from __future__ import annotations

import json
import os

import numpy as np

# NeRF-synthetic lego's horizontal field of view (transforms_train.json)
LEGO_CAMERA_ANGLE_X = 0.6911112070083618
BLENDER_FRAMES = 100
# the [H, W, focal] column of a 4032x3024 LLFF capture
LLFF_HWF = (3024.0, 4032.0, 3260.0)


def _look_at(eye, target, up):
    """OpenGL camera-to-world (x right, y up, z back) at `eye`."""
    z = eye - target
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([x, np.cross(z, x), z], 1)
    c2w[:3, 3] = eye
    return c2w


def _blender_c2ws(n=BLENDER_FRAMES, radius=4.0):
    """(n, 4, 4) OpenGL c2w on the upper sphere about the origin: golden-
    angle azimuths, elevations 15-60 degrees."""
    out = []
    for i in range(n):
        theta = 2 * np.pi * ((i * 0.6180339887) % 1.0)
        phi = np.deg2rad(15.0 + 45.0 * ((i * 0.381966) % 1.0))
        eye = radius * np.array([np.cos(phi) * np.cos(theta),
                                 np.cos(phi) * np.sin(theta), np.sin(phi)])
        out.append(_look_at(eye, np.zeros(3), np.array([0.0, 0.0, 1.0])))
    return np.stack(out)


def write_blender_scene(root, res=800, frames=(), seed=0):
    """A Blender scene under `root`: the 100 frames' poses, and a res x res
    RGBA PNG for each frame index in `frames`."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    meta = {"camera_angle_x": LEGO_CAMERA_ANGLE_X,
            "frames": [{"file_path": f"./train/r_{i}",
                        "transform_matrix": c2w.tolist()}
                       for i, c2w in enumerate(_blender_c2ws())]}
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump(meta, f, indent=2)
    yy, xx = np.mgrid[:res, :res] / res - 0.5
    r = np.hypot(xx, yy)
    alpha = np.clip((0.4 - r) / 0.05, 0, 1)
    for i in frames:
        img = rng.integers(0, 256, (res, res, 4), np.uint8)
        img[..., 3] = np.round(alpha * 255).astype(np.uint8)
        Image.fromarray(img, "RGBA").save(
            os.path.join(root, "train", f"r_{int(i)}.png"))


def _llff_poses_bounds(n=20, rng=None):
    """(n, 17) poses_bounds rows: forward-facing OpenGL cameras on a 5 x 4
    grid 0.15 apart in x and y, turned up to ~2 degrees, stored as
    [down, right, back, centre | H, W, focal] columns, and [near, far]."""
    rng = np.random.default_rng(0) if rng is None else rng
    rows = np.zeros((n, 17))
    for i in range(n):
        eye = np.array([0.15 * (i % 5 - 2), 0.15 * (i // 5 - 1.5), 0.0])
        target = np.array([0.0, 0.0, -10.0]) + rng.uniform(-0.3, 0.3, 3)
        c2w = _look_at(eye, target, np.array([0.0, 1.0, 0.0]))
        x, y, z = c2w[:3, 0], c2w[:3, 1], c2w[:3, 2]
        pose = np.stack([-y, x, z, eye, np.asarray(LLFF_HWF)], 1)
        rows[i, :15] = pose.reshape(-1)
        rows[i, 15:] = [rng.uniform(1.5, 2.0), rng.uniform(12.0, 16.0)]
    return rows


def write_llff_scene(root, wh=(960, 640), n=20, seed=0):
    """An LLFF scene under `root`: `poses_bounds.npy` and n PNGs of random
    pixels at `wh` in `images/`."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    np.save(os.path.join(root, "poses_bounds.npy"),
            _llff_poses_bounds(n, rng))
    for i in range(n):
        img = rng.integers(0, 256, (wh[1], wh[0], 3), np.uint8)
        Image.fromarray(img).save(
            os.path.join(root, "images", f"IMG_{i:04d}.png"))

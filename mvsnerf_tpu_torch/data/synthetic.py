"""Hermetic scenes in the DTU, Blender and LLFF datasets' on-disk formats,
made from a seed, for the tests, `chip_smoke.py` and the CLIs (no dataset
is shipped):

- `write_dtu_scene`: a DTU tree (`Cameras/train/`, `Rectified/<scan>_train/`
  with 7 lights a view, `Depths/<scan>/` of 1200x1600 depth maps) of 49
  views in an arc looking at a textured plane ~700 mm away;
  `write_dtu_multiscan` writes several scans under one `Cameras/` and
  their `scans.txt`. Both write the same bytes as the JAX package's
  scripts/make_synthetic_scene.py for the same arguments;
- `write_blender_scene`: `transforms_train.json` with NeRF-synthetic's
  lego field of view and 100 frames on a sphere of radius 4 about the
  origin (Blender / OpenGL c2w, z up), and RGBA PNGs of random pixels
  whose alpha is a disc (opaque inside, a soft rim, clear outside) for
  the frames named;
- `write_llff_scene`: `images/` and `poses_bounds.npy` of 20 forward-facing
  cameras on a 5 x 4 grid, in LLFF's "down right back" layout with
  [H, W, focal] of a 4032x3024 phone capture, near bounds 1.5-2.0 and far
  bounds 12-16.

For Blender and LLFF the directory's name picks the pair table's split
(`lego`, `fern`, ...); the loaders read only the frames the split names.
PIL is imported by the writers only."""

from __future__ import annotations

import json
import os

import numpy as np

from .common import write_cam_file, write_pfm

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


def write_dtu_scene(root, n_views=49, scan="scan1", img_hw=(192, 240),
                    seed=None):
    """One DTU scan under `root` (scripts/make_synthetic_scene.py:20-57):
    49 views so that the pair tables index validly. The cameras'
    intrinsics are DTU's at 640x512: the per-scene loader resizes the
    PNGs, but the generalizable one at downSample 1.0 reads each at its
    own size with them, so write `img_hw=(512, 640)` for it. The GT
    depths are 1200x1600 for the loaders' fixed crop. `seed` defaults to
    the sum of the scan name's code points, so the scans of one tree
    differ."""
    from PIL import Image

    if seed is None:
        seed = sum(ord(c) for c in scan)
    rng = np.random.default_rng(seed)
    os.makedirs(f"{root}/Cameras/train", exist_ok=True)
    os.makedirs(f"{root}/Rectified/{scan}_train", exist_ok=True)
    os.makedirs(f"{root}/Depths/{scan}", exist_ok=True)

    # a textured plane at depth ~700 mm viewed by an arc of cameras
    h, w = img_hw
    tex = rng.uniform(0.1, 0.9, (32, 32, 3))
    base = np.tile(tex, (h // 32 + 1, w // 32 + 1, 1))[:h, :w]
    for vid in range(n_views):
        a = 0.02 * (vid - n_views / 2)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        ext = np.eye(4)
        ext[:3, :3] = R
        ext[:3, 3] = [8.0 * (vid - n_views / 2), 0, 600]
        intr = np.array([[180.0, 0, 80], [0, 180.0, 64], [0, 0, 1]])
        write_cam_file(f"{root}/Cameras/train/{vid:08d}_cam.txt", intr, ext,
                       425.0, 2.5)
        img = np.roll(base, vid * 3, axis=1)
        for light in range(7):
            arr = np.clip(img * (0.7 + 0.05 * light), 0, 1)
            Image.fromarray((arr * 255).astype(np.uint8)).save(
                f"{root}/Rectified/{scan}_train/"
                f"rect_{vid + 1:03d}_{light}_r5000.png")
        depth = np.full((1200, 1600), 700.0, np.float32) + \
            rng.uniform(-20, 20, (1200, 1600)).astype(np.float32)
        write_pfm(f"{root}/Depths/{scan}/depth_map_{vid:04d}.pfm", depth)
    print(f"wrote synthetic DTU scene to {root}/{scan}")


def write_dtu_multiscan(root, scans, **scene):
    """Several scans under `root` sharing one `Cameras/` (the DTU layout),
    and `<root>/scans.txt` for `--scan_list`
    (scripts/make_synthetic_scene.py:60-69). `scene` holds
    `write_dtu_scene`'s keywords for every scan. Take the scan names from
    the packaged train list (scan3, scan4, ...) so that the pair tables
    index validly."""
    for scan in scans:
        write_dtu_scene(root, scan=scan, **scene)
    with open(f"{root}/scans.txt", "w") as f:
        f.write("\n".join(scans) + "\n")
    print(f"wrote {len(scans)} synthetic scans + {root}/scans.txt")

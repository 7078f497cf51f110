"""Shared data-loading utilities: image IO, PFM depth maps and MVSNet camera
files, pose averaging and recentring, and the spiral and spheric render
paths (counterpart of mvsnerf_tpu/data/common.py). Numpy only; PIL is
imported only inside `load_image`, so nothing else here needs it."""

from __future__ import annotations

import io
import re

import numpy as np

# torchvision Normalize constants used by every loader
# (reference data/dtu.py:47-50)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_imagenet(img):
    """img: (..., 3) in [0, 1] -> ImageNet-normalized."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def unnormalize_imagenet(img):
    return img * IMAGENET_STD + IMAGENET_MEAN


def load_image(path, wh=None, method="lanczos", keep_alpha=False):
    """Load an image to float32 (H, W, C) in [0, 1]; optional resize to
    `wh` = (W, H) with 'lanczos' (the per-scene loaders) or 'bilinear'.
    An RGBA file is resized as RGBA (PIL resizes it premultiplied) and
    keeps its alpha with `keep_alpha` (Blender's PNGs), else loses it after
    the resize; other modes are converted to RGB first, unless
    `keep_alpha`, which converts nothing (JAX data/common.py:30)."""
    from PIL import Image

    img = Image.open(path)
    if not keep_alpha and img.mode not in ("RGB", "RGBA"):
        img = img.convert("RGB")
    if wh is not None:
        resample = Image.LANCZOS if method == "lanczos" else Image.BILINEAR
        img = img.resize(tuple(int(x) for x in wh), resample)
    arr = np.asarray(img, np.float32) / 255.0
    if not keep_alpha and arr.ndim == 3 and arr.shape[-1] == 4:
        arr = arr[..., :3]
    return arr


def read_pfm(path):
    """PFM reader (reference utils.py:440-475 semantics): (data (H, W) or
    (H, W, 3) float32, scale)."""
    with open(path, "rb") as f:
        return decode_pfm(f.read(), path)


def decode_pfm(raw: bytes, name: str = "PFM bytes"):
    """`read_pfm` of a PFM file's bytes."""
    f = io.BytesIO(raw)
    header = f.readline().decode("latin-1").rstrip()
    if header not in ("PF", "Pf"):
        raise ValueError(f"not a PFM file: {name}")
    m = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("latin-1"))
    if not m:
        raise ValueError(f"malformed PFM header: {name}")
    width, height = int(m.group(1)), int(m.group(2))
    scale = float(f.readline().decode("latin-1").rstrip())
    endian = "<" if scale < 0 else ">"
    data = np.frombuffer(f.read(), endian + "f")
    shape = (height, width, 3) if header == "PF" else (height, width)
    data = np.flipud(data.reshape(shape))  # PFM stores bottom-up
    return np.ascontiguousarray(data, np.float32), abs(scale)


def write_pfm(path, image, scale=1.0):
    """PFM writer (little-endian)."""
    image = np.asarray(image, np.float32)
    color = image.ndim == 3 and image.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-scale}\n".encode())
        np.flipud(image).astype("<f").tofile(f)


def read_cam_file(path, scale_factor=1.0 / 200):
    """MVSNet `*_cam.txt` parser (reference data/dtu.py:101-114): intrinsic
    (3, 3), extrinsic (4, 4) with its translation scaled, [depth_min,
    depth_max] scaled, the raw depth interval."""
    with open(path) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extrinsic = np.array(" ".join(lines[1:5]).split(),
                         np.float32).reshape(4, 4)
    intrinsic = np.array(" ".join(lines[7:10]).split(),
                         np.float32).reshape(3, 3)
    depth_min = float(lines[11].split()[0]) * scale_factor
    depth_interval = float(lines[11].split()[1])
    depth_max = depth_min + depth_interval * 192 * scale_factor
    extrinsic[:3, 3] *= scale_factor
    return intrinsic, extrinsic, [depth_min, depth_max], depth_interval


def write_cam_file(path, intrinsic, extrinsic, depth_min, depth_interval):
    """MVSNet cam.txt writer."""
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for row in np.asarray(extrinsic).reshape(4, 4):
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
        f.write("\nintrinsic\n")
        for row in np.asarray(intrinsic).reshape(3, 3):
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
        f.write(f"\n{depth_min} {depth_interval}\n")


def resize_nearest(img, fx=None, fy=None, out_wh=None):
    """Nearest-neighbour resize matching cv2.resize INTER_NEAREST (the GT
    depth pyramids, data/dtu.py:118-124), by factors `fx`, `fy` or to
    `out_wh` = (W, H)."""
    h, w = img.shape[:2]
    if out_wh is None:
        out_w, out_h = int(round(w * fx)), int(round(h * fy))
    else:
        out_w, out_h = out_wh
    xs = np.minimum((np.arange(out_w) * (w / out_w)).astype(np.int64), w - 1)
    ys = np.minimum((np.arange(out_h) * (h / out_h)).astype(np.int64), h - 1)
    return img[ys[:, None], xs[None, :]]


# Blender / OpenGL camera (x right, y up, z back) -> OpenCV (x right, y
# down, z forward), right-multiplied onto a c2w
BLENDER2OPENCV = np.array([[1, 0, 0, 0], [0, -1, 0, 0],
                           [0, 0, -1, 0], [0, 0, 0, 1]], np.float64)


def _normalize(v):
    return v / np.linalg.norm(v)


def average_pose(poses):
    """Mean camera pose of (N, 3, 4) poses (reference data/llff.py:17-51):
    (3, 4) with the mean centre, the normalised mean z axis, y from the
    mean y and x = y x z."""
    center = poses[..., 3].mean(0)
    z = _normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = _normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses, blender2opencv=BLENDER2OPENCV):
    """Recentre (N, 3, 4) poses on their average pose, then convert them
    with `blender2opencv` (data/llff.py:55-80): (the centred (N, 3, 4)
    poses, the (4, 4) transform applied)."""
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = average_pose(poses)
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    centered = np.linalg.inv(pose_avg_homo) @ poses_homo
    centered = centered @ blender2opencv
    return centered[:, :3], np.linalg.inv(pose_avg_homo) @ blender2opencv


def create_spiral_poses(radii, focus_depth, n_poses=120):
    """Spiral render path (data/llff.py:83-113): (n_poses, 3, 4)."""
    out = []
    for t in np.linspace(0, 4 * np.pi, n_poses + 1)[:-1]:
        center = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * radii
        z = _normalize(center - np.array([0, 0, -focus_depth]))
        x = _normalize(np.cross(np.array([0, 1.0, 0]), z))
        y = np.cross(z, x)
        out.append(np.stack([x, y, z, center], 1))
    return np.stack(out)


def create_spheric_poses(radius, n_poses=120, phi=-np.pi / 5):
    """Circular render path around z (data/llff.py:116-154):
    (n_poses, 3, 4)."""
    def spheric_pose(theta):
        trans_t = np.array([[1, 0, 0, 0], [0, 1, 0, -0.9 * radius],
                            [0, 0, 1, radius], [0, 0, 0, 1.0]])
        rot_phi = np.array([[1, 0, 0, 0],
                            [0, np.cos(phi), -np.sin(phi), 0],
                            [0, np.sin(phi), np.cos(phi), 0], [0, 0, 0, 1]])
        rot_theta = np.array([[np.cos(theta), 0, -np.sin(theta), 0],
                              [0, 1, 0, 0],
                              [np.sin(theta), 0, np.cos(theta), 0],
                              [0, 0, 0, 1]])
        c2w = rot_theta @ rot_phi @ trans_t
        c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                        [0, 0, 0, 1.0]]) @ c2w
        return c2w[:3]

    return np.stack([spheric_pose(th)
                     for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]])

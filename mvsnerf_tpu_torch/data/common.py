"""Shared data-loading utilities: image IO, PFM depth maps and MVSNet camera
files (counterpart of mvsnerf_tpu/data/common.py, the parts the dtu_ft
loader reads). Numpy only; PIL is imported only inside `load_image`, so
nothing else here needs it."""

from __future__ import annotations

import re

import numpy as np

# torchvision Normalize constants used by every loader
# (reference data/dtu.py:47-50)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_imagenet(img):
    """img: (..., 3) in [0, 1] -> ImageNet-normalized."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def load_image(path, wh=None, method="lanczos"):
    """Load an RGB image to float32 (H, W, 3) in [0, 1]; optional resize
    to `wh` = (W, H) with 'lanczos' (the per-scene loaders) or
    'bilinear'."""
    from PIL import Image

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    if wh is not None:
        resample = Image.LANCZOS if method == "lanczos" else Image.BILINEAR
        img = img.resize(tuple(int(x) for x in wh), resample)
    return np.asarray(img, np.float32) / 255.0


def read_pfm(path):
    """PFM reader (reference utils.py:440-475 semantics): (data (H, W) or
    (H, W, 3) float32, scale)."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").rstrip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"not a PFM file: {path}")
        m = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("latin-1"))
        if not m:
            raise ValueError(f"malformed PFM header: {path}")
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


def resize_nearest(img, fx, fy):
    """Nearest-neighbour resize matching cv2.resize INTER_NEAREST (the GT
    depth pyramids, data/dtu.py:118-124)."""
    h, w = img.shape[:2]
    out_w, out_h = int(round(w * fx)), int(round(h * fy))
    xs = np.minimum((np.arange(out_w) * (w / out_w)).astype(np.int64), w - 1)
    ys = np.minimum((np.arange(out_h) * (h / out_h)).astype(np.int64), h - 1)
    return img[ys[:, None], xs[None, :]]

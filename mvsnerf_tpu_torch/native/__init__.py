"""Native host-side data pipeline (C++ via ctypes), the counterpart of
mvsnerf_tpu/native/: PFM decoding, the DTU depth pyramid, a multi-threaded
ray-batch gather and ImageNet normalisation, the host loops that feed the
card.

The library is built at first use with g++ from the port's own copy of
the source, `src/mvsnerf_native.cc`,

    g++ -O3 -shared -fPIC -std=c++17 -o _build/libmvsnerf_native_<hash>.so
        src/mvsnerf_native.cc -lpthread

into `mvsnerf_tpu_torch/_build/` (the name carries a hash of the source
and flags, so an edited source is rebuilt and a built one reused). Every
entry point has a numpy fallback, so the package works without a
compiler: `available()` says which route runs, and a failed build logs a
warning (logger `mvsnerf_tpu_torch.native`) with the compiler's output.
Nothing is built at import.

    from mvsnerf_tpu_torch import native
    native.available()          # -> bool
    native.pfm_decode(raw)      # bytes -> (H, W[, 3]) float32
    native.dtu_depth_pipeline(depth, down, value_scale)
    native.ray_gather(rays, rgbs, idx)
    native.imagenet_normalize_inplace(img)
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "mvsnerf_native.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# the JAX package's flags without -march=native: the built library stays
# in _build/, which a checkout copied to another machine carries along
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

log = logging.getLogger(__name__)
_lib = None
_lock = threading.Lock()
_build_failed = False


def _lib_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f"libmvsnerf_native_{digest.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    """Compile the library into `path` (through a file of this process's
    own, then renamed: parallel test workers may build at once)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC),
                               "-lpthread"], capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        log.warning("native library not built (%s); the numpy routes run",
                    e)
        return False
    if proc.returncode != 0:
        log.warning("native library not built (g++ exit %d); the numpy "
                    "routes run:\n%s", proc.returncode, proc.stderr[-2000:])
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, path)
    return True


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _lib_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            log.warning("native library %s not loaded (%s); the numpy "
                        "routes run", path, e)
            _build_failed = True
            return None
        c_i64 = ctypes.c_int64
        c_f32p = ctypes.POINTER(ctypes.c_float)
        lib.pfm_decode.restype = ctypes.c_int
        lib.pfm_decode.argtypes = [ctypes.c_char_p, c_i64, c_f32p,
                                   ctypes.POINTER(c_i64),
                                   ctypes.POINTER(c_i64)]
        lib.dtu_depth_pipeline.restype = ctypes.c_int
        lib.dtu_depth_pipeline.argtypes = [c_f32p, c_i64, c_i64,
                                           ctypes.c_double, ctypes.c_double,
                                           c_f32p, c_i64, c_i64]
        lib.ray_gather.restype = ctypes.c_int
        lib.ray_gather.argtypes = [c_f32p, c_f32p,
                                   ctypes.POINTER(c_i64), c_i64, c_i64,
                                   c_i64, c_i64, c_f32p, c_f32p,
                                   ctypes.c_int]
        lib.imagenet_normalize.restype = ctypes.c_int
        lib.imagenet_normalize.argtypes = [c_f32p, c_i64]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is built and loaded (building it on the
    first call); False means every function here runs its numpy route."""
    return _load() is not None


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def pfm_decode(raw: bytes):
    """PFM bytes -> (H, W) or (H, W, 3) float32 (top-down rows)."""
    lib = _load()
    if lib is None:
        from ..data.common import decode_pfm
        return decode_pfm(raw)[0]
    # the output's size from the header, parsed in Python
    lines = raw.split(b"\n", 3)
    w, h = (int(x) for x in lines[1].split())
    channels = 3 if lines[0].strip() == b"PF" else 1
    out = np.empty(h * w * channels, np.float32)
    oh, ow = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.pfm_decode(raw, len(raw), _fptr(out), ctypes.byref(oh),
                        ctypes.byref(ow))
    if rc < 0:
        raise ValueError("pfm_decode failed")
    return out.reshape((h, w, 3) if rc == 3 else (h, w))


def dtu_depth_pipeline(depth: np.ndarray, down: float = 1.0,
                       value_scale: float = 1.0):
    """DTU GT depth pyramid: x0.5 nearest -> crop [44:556, 80:720] ->
    downSample -> value scale (reference data/dtu.py:116-127); (round(512
    down), round(640 down)) float32."""
    lib = _load()
    out_h = int(round(512 * down))
    out_w = int(round(640 * down))
    if lib is None:
        from ..data.common import resize_nearest
        d = resize_nearest(depth, 0.5, 0.5)[44:556, 80:720]
        if down != 1.0:
            d = resize_nearest(d, out_wh=(out_w, out_h))
        return (d * value_scale).astype(np.float32)
    depth = np.ascontiguousarray(depth, np.float32)
    if depth.ndim != 2:
        raise ValueError(f"dtu_depth_pipeline: depth {depth.shape} is not "
                         "(H, W)")
    out = np.empty((out_h, out_w), np.float32)
    rc = lib.dtu_depth_pipeline(_fptr(depth), depth.shape[0], depth.shape[1],
                                down, value_scale, _fptr(out), out_h, out_w)
    if rc != 0:
        raise ValueError("dtu_depth_pipeline failed (input too small?)")
    return out


def ray_gather(rays: np.ndarray, rgbs: np.ndarray, idx: np.ndarray,
               num_threads: int = 4):
    """(rays[idx], rgbs[idx]) of (n, rc) and (n, cc) float32 buffers,
    copied by `num_threads` threads (one below 4096 rows) with the
    interpreter lock released. Other dtypes or ranks, or a missing library,
    take numpy's gather, so the result always equals `rays[idx],
    rgbs[idx]` bit for bit. The native route takes indices in [0, n) only
    and raises IndexError for others."""
    lib = _load()
    if lib is None or any(a.dtype != np.float32 or a.ndim != 2
                          for a in (rays, rgbs)):
        return rays[idx], rgbs[idx]
    rays = np.ascontiguousarray(rays)
    rgbs = np.ascontiguousarray(rgbs)
    idx = np.ascontiguousarray(idx, np.int64)
    if len(rays) != len(rgbs) or idx.ndim != 1:
        raise ValueError(f"ray_gather: rays {rays.shape}, rgbs {rgbs.shape}, "
                         f"idx {idx.shape}")
    if len(idx) and (idx.min() < 0 or idx.max() >= len(rays)):
        raise IndexError(f"ray_gather: indices outside [0, {len(rays)})")
    m = len(idx)
    out_rays = np.empty((m, rays.shape[1]), np.float32)
    out_rgbs = np.empty((m, rgbs.shape[1]), np.float32)
    lib.ray_gather(_fptr(rays), _fptr(rgbs),
                   idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                   len(rays), m, rays.shape[1], rgbs.shape[1],
                   _fptr(out_rays), _fptr(out_rgbs), num_threads)
    return out_rays, out_rgbs


def imagenet_normalize_inplace(img: np.ndarray):
    """(..., 3) float32 in [0, 1] -> ImageNet-normalised, in place. The
    native route multiplies by 1 / std where numpy divides by std: the two
    differ by up to one rounding."""
    lib = _load()
    if lib is None:
        from ..data.common import normalize_imagenet
        img[:] = normalize_imagenet(img)
        return img
    if img.shape[-1] != 3:
        raise ValueError(f"imagenet_normalize_inplace: {img.shape} is not "
                         "(..., 3)")
    flat = np.ascontiguousarray(img, np.float32)
    lib.imagenet_normalize(_fptr(flat), flat.size // 3)
    img[:] = flat.reshape(img.shape)
    return img

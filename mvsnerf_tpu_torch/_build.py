"""Build and bind the hand-written CUDA kernels under csrc/.

At first use, every csrc/*.cu is compiled by nvcc into one shared library
with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v
         -o _build/libmvsnerf_kernels_<hash>.so csrc/*.cu

and loaded with ctypes. The file name carries a hash of the sources and
flags, so an edited kernel is rebuilt and a built one is reused. Every C
entry point takes its pointers and the CUDA stream as `void*` and returns
`cudaGetLastError()` after the launch; `check` raises on a non-zero code.

Nothing here runs at import time: the CPU tests import every module on a
machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argument types (pointers and the stream as void*)
SIGNATURES = {
    # srcs, proj, depths, out, V, h, w, C, D, pad, stream
    "sweep_cost_volume": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # pts, w2cs, intrinsics, imgs, out, M, V, H, W, stream
    "color_warp": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # ndc, z, colors, dirs, vol, weights, out, N, S, D, HP, WP,
    # n_weights, stream
    "render_v0": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}

_lib = None
build_log = ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library() -> ctypes.CDLL:
    """The kernel library, built on first call; a fresh build leaves the
    compiler's output, ptxas's per-kernel register and spill report
    included, in `build_log`."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    srcs = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libmvsnerf_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               *map(str, srcs)],
                              capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream

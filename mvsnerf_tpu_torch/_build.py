"""Build and bind the hand-written CUDA kernels under csrc/.

At first use, each csrc/*.cu is compiled by its own nvcc, all at once
(the headers csrc/*.cuh are included by them),

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
         -fPIC -Xptxas -v -c -o <obj> csrc/<name>.cu

and the objects are linked into one shared library with a plain C
interface (`nvcc -shared -o _build/libmvsnerf_kernels_<hash>.so`), loaded
with ctypes. The file name carries a hash of the sources, headers and
flags, so an
edited kernel is rebuilt and a built one is reused. Every C entry point
takes its pointers and the CUDA stream as `void*` and returns
`cudaGetLastError()` after the launch; `check` raises on a non-zero code.

Nothing here runs at import time: the CPU tests import every module on a
machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argument types (pointers and the stream as void*)
SIGNATURES = {
    # srcs, packed (scratch), proj, depths, out, V, h, w, C, D, pad, stream
    "sweep_cost_volume": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # g and its (channel, plane, row, column) strides, srcs, proj, depths,
    # gsrc, V, h, w, C, D, pad, taps (or null), stream
    "sweep_cost_volume_bwd": [_P, _L, _L, _L, _L, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _P, _P],
    # pts, w2cs, intrinsics, imgs, out, M, V, H, W, stream
    "color_warp": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # g, pts, w2cs, intrinsics, gimgs, M, V, H, W, stream
    "color_warp_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # ndc, z, colors (or null), dirs, vol, weights, tc, out, N, S, D, HP,
    # WP, C, n_weights, n_tc, stream
    "render_v0": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                  _I, _P],
    # ndc, z, feats, dirs, weights, tc, out, wout, aout (or null), N, S,
    # n_weights, n_tc, stream
    "render_v0_feats": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _P],
    # -> bytes of dynamic shared memory the render body takes a block
    "render_v0_smem_bytes": [],
    # vol, ndc, out, n_samples, D, HP, WP, C, stream
    "volume_gather_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # g, ndc, gvol, n_samples, D, HP, WP, C, adds (or null), stream
    "volume_splat_bwd": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # w, streams, n_weights, stream
    "mlp_v0_pack": [_P, _P, _I, _P],
    # x, w, out, N, n_weights, scratch, its floats, save, stream
    "mlp_v0_fwd": [_P, _P, _P, _I, _I, _P, _L, _I, _P],
    # g, x, w, scratch, its floats, work, its floats, dw, dx, N, n_splits,
    # n_weights, stream
    "mlp_v0_bwd": [_P, _P, _P, _P, _L, _P, _L, _P, _P, _I, _I, _I, _P],
    # Wi, Wo -> 1 when a stride-2 conv3d_fwd runs its pair kernel
    "conv3d_s2_pairs": [_I, _I],
    # x, w, packed, y, Cin, Cout, Di, Hi, Wi, Do, Ho, Wo, stride, packed's
    # floats, stream
    "conv3d_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   _P],
    # x, w, y, Cin, Cout, Di, Hi, Wi, Do, Ho, Wo, stream
    "conv3d_up": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # A, B, Dg, Hg, Wg, stride -> rows of the partial buffer conv3d_wgrad
    # needs
    "conv3d_wgrad_splits": [_I, _I, _I, _I, _I, _I],
    # g, x, partial, dw, A, B, Dg, Hg, Wg, Dx, Hx, Wx, stride, n_splits,
    # stream
    "conv3d_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                     _P],
}

_lib = None
build_log = ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _build(srcs, so: Path) -> str:
    """Compile every source with its own nvcc, all started together, and
    link the objects into `so`; returns the compilers' output."""
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        objs = [tmp / f"{src.stem}.o" for src in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        log = ""
        failed = []
        for src, proc in zip(srcs, procs):
            out = proc.communicate()[0]
            log += f"== {src.name}\n{out}"
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode})")
        if not failed:
            lib = tmp / "lib.so"
            proc = subprocess.run([nvcc, "-shared", "-o", str(lib),
                                   *map(str, objs)],
                                  capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode})")
            else:
                os.replace(lib, so)
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
        return log
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The kernel library, built on first call; a fresh build leaves the
    compilers' output, ptxas's per-kernel register and spill report
    included, in `build_log`."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    srcs = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs + sorted(SRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libmvsnerf_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        build_log = _build(srcs, so)
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
    """The raw handle of the current CUDA stream on `t`'s device, read
    straight from PyTorch's C binding: `torch.cuda.current_stream` builds a
    Stream object on each call, host time that every launch would pay."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())

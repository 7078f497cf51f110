"""PyTorch + CUDA port of `mvsnerf_tpu` for an NVIDIA Hopper card (H100).

The JAX package `mvsnerf_tpu` stays beside this one as the reference that
every module here is tested against. This package imports torch and numpy
only, never jax and never `mvsnerf_tpu`.

Layout (the old module paths, so a reader finds each counterpart):

    ops/        geometry, sampling, encoding, compositing, interp,
                homography; the kernel wrappers sweep (K1, K2), color_warp
                (K4), render_fused (K6), volume_gather (K5) and mlp_train
                (K7), each with its plain PyTorch twin
    models/     ABN layers, FeatureNet + CostRegNet (MVSNet), the v0 MLP
    io/         reference-checkpoint state dicts, snapshots
    render/     chunked renderer, hybrid (fused-kernel) renderer
    eval/       the no-finetune Evaluator
    train/      the fine-tune and generalizable trainers
    data/       the dtu_ft and dtu loaders
    csrc/       hand-written CUDA kernels for sm_90a, built at first use by
                `_build.py` into `_build/`

Public functions keep the JAX layouts: channel-last volumes (D, hp, wp, C)
and images (V, H, W, 3).

Precision policy: float32 everywhere, with TF32 off for both cuBLAS
matmuls and cuDNN convolutions. cuDNN runs float32 convolutions in TF32 by
default, which keeps about three decimal digits; the cost volume's variance
E[x^2] - E[x]^2 cancels catastrophically and does not survive that. The
entry points (`eval.evaluate.Evaluator`, the trainers, `chip_smoke.py`)
call `set_precision_policy()`.

Device policy: the entry points run on the first CUDA card unless the
caller names the CPU (`device="cpu"`, `--device cpu`); with no card they
raise instead of falling back (`resolve_device`).
"""

import torch


def set_precision_policy() -> None:
    """Full float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for and torch sees no card: the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no route for device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device cpu) "
                           "to run on the CPU")
    return dev

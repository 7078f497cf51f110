"""PyTorch + CUDA port of `mvsnerf_tpu` for an NVIDIA Hopper card (H100).

The JAX package `mvsnerf_tpu` stays beside this one as the reference that
every module here is tested against. This package imports torch and numpy
only, never jax and never `mvsnerf_tpu`.

Layout (the old module paths, so a reader finds each counterpart):

    ops/        geometry, sampling, encoding, compositing, interp,
                homography; the kernel wrappers sweep (K1), color_warp (K4)
                and render_fused (K6), each with its plain PyTorch twin
    models/     ABN layers, FeatureNet + CostRegNet (MVSNet), the v0 MLP
    io/         reference-checkpoint state dicts
    render/     chunked renderer, hybrid (fused-kernel) renderer
    eval/       the no-finetune Evaluator
    csrc/       hand-written CUDA kernels for sm_90a, built at first use by
                `_build.py` into `_build/`

Public functions keep the JAX layouts: channel-last volumes (D, hp, wp, C)
and images (V, H, W, 3).

Precision policy: float32 everywhere, with TF32 off for both cuBLAS
matmuls and cuDNN convolutions. cuDNN runs float32 convolutions in TF32 by
default, which keeps about three decimal digits; the cost volume's variance
E[x^2] - E[x]^2 cancels catastrophically and does not survive that. The
entry points (`eval.evaluate.Evaluator`, `chip_smoke.py`) call
`set_precision_policy()`.
"""

import torch


def set_precision_policy() -> None:
    """Full float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

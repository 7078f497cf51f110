"""Learning-rate schedules (counterpart of mvsnerf_tpu/utils/schedulers.py):
MultiStepLR / cosine / poly, with optional linear warmup, as plain
step -> lr functions with optax's values at every count.

A schedule plugs into PyTorch as `LambdaLR(opt, lambda s: fn(s) / lrate)`:
LambdaLR's step counter starts at 0 and advances after each optimizer
step, so update k uses fn(k), as optax's count does.
"""

from __future__ import annotations

import math


def make_lr_schedule(lrate: float, scheduler: str = "steplr",
                     decay_step=(5000, 8000, 9000), decay_gamma: float = 0.5,
                     num_steps: int = 10000, warmup_steps: int = 0,
                     poly_exp: float = 0.9, eta_min: float = 1e-8):
    """Returns fn(step) -> lr.

    steplr: lrate times `decay_gamma` once for every boundary <= step
    (optax.piecewise_constant_schedule: halved AT the boundary).
    cosine: optax.cosine_decay_schedule(lrate, num_steps, eta_min / lrate).
    poly: optax.polynomial_schedule(lrate, 0, poly_exp, num_steps).
    warmup: linear 0 -> lrate over `warmup_steps`, then the base schedule
    counted from the end of the warmup (optax.join_schedules).
    """
    if scheduler == "steplr":
        bounds = sorted(int(s) for s in decay_step)

        def base(step):
            return lrate * decay_gamma ** sum(step >= b for b in bounds)
    elif scheduler == "cosine":
        alpha = eta_min / lrate

        def base(step):
            t = min(step, num_steps)
            cos = 0.5 * (1 + math.cos(math.pi * t / num_steps))
            return lrate * ((1 - alpha) * cos + alpha)
    elif scheduler == "poly":
        def base(step):
            t = min(max(step, 0), num_steps)
            return lrate * (1 - t / num_steps) ** poly_exp
    else:
        raise ValueError(f"unknown scheduler {scheduler}")
    if warmup_steps > 0:
        def warmed(step):
            if step < warmup_steps:
                return lrate * max(step, 0) / warmup_steps
            return base(step - warmup_steps)
        return warmed
    return base

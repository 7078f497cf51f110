"""Ray-marching sample generation (stratified depths).

Counterpart of mvsnerf_tpu/ops/sampling.py. Where JAX took a PRNG key,
these take an optional `torch.Generator`; the eval path uses perturb=0 and
draws nothing.
"""

from __future__ import annotations

import torch


def stratified_z_vals(near, far, n_rays: int, n_samples: int,
                      perturb: float = 0.0, lindisp: bool = False,
                      generator: torch.Generator | None = None):
    """Depth values along rays.

    Args:
        near, far: scalars or (n_rays, 1) tensors.
        perturb: jitter magnitude in [0, 1]; draws from `generator`.
    Returns:
        z_vals: (n_rays, n_samples).
    """
    device = near.device if torch.is_tensor(near) else None
    t = torch.linspace(0.0, 1.0, n_samples, device=device)
    if lindisp:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        z = near * (1.0 - t) + far * t
    z_vals = z.expand(n_rays, n_samples)
    if perturb > 0:
        mids = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([mids, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], mids], dim=-1)
        u = perturb * torch.rand(z_vals.shape, generator=generator,
                                 device=z_vals.device)
        z_vals = lower + (upper - lower) * u
    return z_vals


def ray_marcher(rays, n_samples: int, perturb: float = 0.0,
                lindisp: bool = False,
                generator: torch.Generator | None = None):
    """Sample points along flat ray buffers.

    Args:
        rays: (N, 8) = [origin(3), dir(3), near, far].
    Returns:
        (xyz (N, S, 3), rays_o (N, 3), rays_d (N, 3), z_vals (N, S)).
    """
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    z_vals = stratified_z_vals(near, far, rays.shape[0], n_samples,
                               perturb=perturb, lindisp=lindisp,
                               generator=generator)
    xyz = rays_o[:, None] + rays_d[:, None] * z_vals[..., None]
    return xyz, rays_o, rays_d, z_vals

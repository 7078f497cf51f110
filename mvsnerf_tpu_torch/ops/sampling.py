"""Ray-marching sample generation: stratified depths and inverse-CDF
importance samples from a baked density volume.

Counterpart of mvsnerf_tpu/ops/sampling.py. Where JAX took a PRNG key,
these take an optional `torch.Generator`; the eval path uses perturb=0 and
draws nothing. `sample_pdf` and `ray_marcher_fine` also take the uniforms
themselves (`u=`), so that a caller can feed them another source's draws.
"""

from __future__ import annotations

import torch

from .compositing import raw2alpha
from .interp import grid_sample_3d


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


def sample_pdf(bins, weights, n_samples: int, det: bool = False,
               generator: torch.Generator | None = None, u=None):
    """Inverse-CDF sampling (reference ray_utils.py:98-141, JAX
    sampling.py:40).

    Args:
        bins: (N, M) bin edges (z_vals midpoints).
        weights: (N, M - 1) unnormalised density weights.
        det: evenly spaced quantiles instead of random ones.
        generator: the source of the uniforms (unless `det` or `u`).
        u: (N, n_samples) uniforms in [0, 1) to use as they are.
    Returns:
        (N, n_samples) sampled depths.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    shape = (*cdf.shape[:-1], n_samples)
    if u is None and det:
        u = torch.linspace(0.0, 1.0, n_samples,
                           device=cdf.device).expand(shape)
    elif u is None:
        u = torch.rand(shape, generator=generator, device=cdf.device)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    last = bins.shape[-1] - 1
    bins_below = torch.gather(bins, -1, torch.clamp(below, max=last))
    bins_above = torch.gather(bins, -1, torch.clamp(above, max=last))
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def dda(rays_o, rays_d, bbox_3d):
    """Ray / axis-aligned box intersection (reference ray_utils.py:143-150).

    Args:
        rays_o, rays_d: (N, 3).
        bbox_3d: (2, 3) [min; max].
    Returns:
        (t_min, t_max), each (N, 1).
    """
    inv_d = 1.0 / (rays_d + 1e-6)
    t0 = (bbox_3d[:1] - rays_o) * inv_d
    t1 = (bbox_3d[1:] - rays_o) * inv_d
    t = torch.stack([t0, t1])
    t_min = torch.amax(torch.amin(t, dim=0), dim=-1, keepdim=True)
    t_max = torch.amin(torch.amax(t, dim=0), dim=-1, keepdim=True)
    return t_min, t_max


def ray_marcher(rays, n_samples: int, perturb: float = 0.0,
                lindisp: bool = False,
                generator: torch.Generator | None = None, bbox_3d=None):
    """Sample points along flat ray buffers.

    Args:
        rays: (N, 8) = [origin(3), dir(3), near, far].
        bbox_3d: (2, 3) world box; when given, each ray's near and far are
            where it enters and leaves the box (`dda`), not its own.
    Returns:
        (xyz (N, S, 3), rays_o (N, 3), rays_d (N, 3), z_vals (N, S)).
    """
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    if bbox_3d is not None:
        near, far = dda(rays_o, rays_d, bbox_3d)
    z_vals = stratified_z_vals(near, far, rays.shape[0], n_samples,
                               perturb=perturb, lindisp=lindisp,
                               generator=generator)
    xyz = rays_o[:, None] + rays_d[:, None] * z_vals[..., None]
    return xyz, rays_o, rays_d, z_vals


def ray_marcher_fine(rays, density_volume, z_vals, pts_ndc,
                     n_importance: int = 64,
                     generator: torch.Generator | None = None, u=None):
    """Importance-resample depths from a baked density volume (reference
    ray_utils.py:199-223, JAX sampling.py:116): sigma at the coarse samples
    (a trilinear `grid_sample` of the volume, as JAX reads it through XLA),
    alpha-compositing weights of relu(sigma), `n_importance` inverse-CDF
    draws over the inner weights at the coarse mid-points, detached, sorted
    in with the coarse depths.

    Args:
        rays: (N, 8) flat rays.
        density_volume: (D, H, W, 1) channel-last sigma volume.
        z_vals: (N, S) coarse depths; pts_ndc: (N, S, 3) their NDC in
            [0, 1].
        generator / u: the uniforms' source, as in `sample_pdf`.
    Returns:
        (xyz (N, S + I, 3), rays_o, rays_d, z_vals (N, S + I)).
    """
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    sigma = grid_sample_3d(density_volume, pts_ndc * 2.0 - 1.0)[..., 0]
    _, weights = raw2alpha(torch.relu(sigma))
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    z_samples = sample_pdf(z_mid, weights[:, 1:-1], n_importance,
                           generator=generator, u=u).detach()
    z_vals = torch.sort(torch.cat([z_samples, z_vals], dim=-1), dim=-1)[0]
    xyz = rays_o[:, None] + rays_d[:, None] * z_vals[..., None]
    return xyz, rays_o, rays_d, z_vals

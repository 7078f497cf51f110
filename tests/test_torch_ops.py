"""The port's geometry, sampling, encoding, compositing and interp ops
against the JAX package's, on the same numpy inputs made from a seed, on
the CPU. Tolerance: abs <= 1e-5 (f32 element-wise math; the tests with
wider-range outputs say why they scale it)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_common import t

from mvsnerf_tpu.ops import compositing as jc, encoding as je, \
    geometry as jg, interp as ji, sampling as js
from mvsnerf_tpu_torch.ops import compositing as pc, encoding as pe, \
    geometry as pg, interp as pi, sampling as ps

RNG = np.random.default_rng(7)
ATOL = 1e-5


def _close(out, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=0,
                               atol=atol)


def _pose(a=0.1, tx=0.3):
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]], np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3], m[:3, 3] = R, [tx, -0.1, 0.2]
    return m


INTR = np.array([[80.0, 0, 48.0], [0, 82.0, 32.0], [0, 0, 1]], np.float32)


def test_get_ray_directions_and_rays():
    dirs_j = jg.get_ray_directions(12, 20, (80.0, 82.0), (9.5, 6.0))
    dirs_p = pg.get_ray_directions(12, 20, (80.0, 82.0), (9.5, 6.0))
    _close(dirs_p, dirs_j)
    c2w = _pose()
    o_j, d_j = jg.get_rays(jnp.asarray(dirs_j), jnp.asarray(c2w))
    o_p, d_p = pg.get_rays(dirs_p, t(c2w))
    _close(o_p, o_j)
    _close(d_p, d_j)


def test_rays_from_pixels():
    xs = RNG.uniform(0, 95, 50).astype(np.float32)
    ys = RNG.uniform(0, 63, 50).astype(np.float32)
    c2w = _pose(-0.2)
    o_j, d_j = jg.rays_from_pixels(jnp.asarray(xs), jnp.asarray(ys),
                                   jnp.asarray(INTR), jnp.asarray(c2w))
    o_p, d_p = pg.rays_from_pixels(t(xs), t(ys), t(INTR), t(c2w))
    _close(o_p, o_j)
    _close(d_p, d_j)


@pytest.mark.parametrize("pad,lindisp", [(0, False), (24, False),
                                         (4, True)])
def test_get_ndc_coordinate(pad, lindisp):
    pts = (RNG.standard_normal((40, 7, 3)) * [0.5, 0.5, 0.3]
           + [0, 0, 3.0]).astype(np.float32)
    w2c = _pose(0.05, 0.1)
    inv_scale = np.array([95.0, 63.0], np.float32)
    ref = jg.get_ndc_coordinate(jnp.asarray(w2c), jnp.asarray(INTR),
                                jnp.asarray(pts), jnp.asarray(inv_scale),
                                near=2.0, far=4.5, pad=pad, lindisp=lindisp)
    out = pg.get_ndc_coordinate(t(w2c), t(INTR), t(pts), t(inv_scale),
                                near=2.0, far=4.5, pad=pad, lindisp=lindisp)
    _close(out, ref)


@pytest.mark.parametrize("lindisp", [False, True])
def test_ray_marcher_deterministic(lindisp):
    rays = np.concatenate([RNG.standard_normal((30, 6)),
                           np.full((30, 1), 2.125), np.full((30, 1), 4.525)],
                          -1).astype(np.float32)
    import jax
    ref = js.ray_marcher(jax.random.PRNGKey(0), jnp.asarray(rays), 16,
                         perturb=0.0, lindisp=lindisp)
    out = ps.ray_marcher(t(rays), 16, lindisp=lindisp)
    for o, r in zip(out, ref):
        # xyz = o + d * z reaches |4.5 * 3|: scale the f32 tolerance
        _close(o, r, atol=ATOL * (1 + np.abs(np.asarray(r)).max()))


def test_stratified_perturb_uses_generator():
    """perturb > 0 draws from the given torch.Generator: the same seed
    gives the same depths, each inside its stratum."""
    near = torch.full((5, 1), 2.0)
    far = torch.full((5, 1), 6.0)
    a = ps.stratified_z_vals(near, far, 5, 9, perturb=1.0,
                             generator=torch.Generator().manual_seed(3))
    b = ps.stratified_z_vals(near, far, 5, 9, perturb=1.0,
                             generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    base = ps.stratified_z_vals(near, far, 5, 9)
    assert torch.all(a >= base - 0.25) and torch.all(a <= base + 0.25)
    assert torch.all(a[:, 1:] >= a[:, :-1])


@pytest.mark.parametrize("num_freqs", [0, 4, 10])
def test_positional_encoding(num_freqs):
    x = RNG.uniform(0, 1, (33, 3)).astype(np.float32)
    ref = je.positional_encoding(jnp.asarray(x), num_freqs)
    _close(pe.positional_encoding(t(x), num_freqs), ref)


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_raw2outputs(white_bkgd):
    raw = np.concatenate([RNG.uniform(0, 1, (20, 16, 3)),
                          RNG.exponential(0.3, (20, 16, 1))], -1
                         ).astype(np.float32)
    z = np.sort(RNG.uniform(2, 6, (20, 16)), -1).astype(np.float32)
    ref = jc.raw2outputs(jnp.asarray(raw), jnp.asarray(z),
                         white_bkgd=white_bkgd)
    out = pc.raw2outputs(t(raw), t(z), white_bkgd=white_bkgd)
    for k in ("rgb", "acc", "weights", "alpha"):
        _close(out[k], ref[k])
    # depth and disp are ~6 and ~1/6: relative f32 scale
    _close(out["depth"], ref["depth"], atol=ATOL * 6)
    _close(out["disp"], ref["disp"], atol=ATOL)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_2d(padding_mode):
    img = RNG.uniform(0, 1, (9, 13, 5)).astype(np.float32)
    grid = RNG.uniform(-1.3, 1.3, (4, 6, 2)).astype(np.float32)
    ref = ji.grid_sample_2d(jnp.asarray(img), jnp.asarray(grid),
                            padding_mode)
    _close(pi.grid_sample_2d(t(img), t(grid), padding_mode), ref)


def test_grid_sample_3d_and_index_point_feature():
    vol = RNG.standard_normal((6, 7, 9, 8)).astype(np.float32)
    grid = RNG.uniform(-1.2, 1.2, (5, 11, 3)).astype(np.float32)
    _close(pi.grid_sample_3d(t(vol), t(grid)),
           ji.grid_sample_3d(jnp.asarray(vol), jnp.asarray(grid)))
    ndc = RNG.uniform(-0.1, 1.1, (5, 11, 3)).astype(np.float32)
    _close(pi.index_point_feature(t(vol), t(ndc)),
           ji.index_point_feature(jnp.asarray(vol), jnp.asarray(ndc)))


@pytest.mark.parametrize("out_hw,align", [((16, 24), False), ((7, 5), False),
                                          ((10, 14), True)])
def test_interpolate_bilinear_resize(out_hw, align):
    img = RNG.uniform(0, 1, (64, 96, 3)).astype(np.float32)
    ref = ji.interpolate_bilinear_resize(jnp.asarray(img), *out_hw,
                                         align_corners=align)
    _close(pi.interpolate_bilinear_resize(t(img), *out_hw,
                                          align_corners=align), ref)


def test_raw2alpha():
    sigma = RNG.exponential(0.5, (12, 10)).astype(np.float32)
    a_j, w_j = jc.raw2alpha(jnp.asarray(sigma))
    a_p, w_p = pc.raw2alpha(t(sigma))
    _close(a_p, a_j)
    _close(w_p, w_j)


@pytest.mark.parametrize("lindisp", [False, True])
def test_depth_plane_values(lindisp):
    from mvsnerf_tpu.models.mvsnet import depth_plane_values as jd
    from mvsnerf_tpu_torch.models.mvsnet import depth_plane_values as pd
    _close(pd(2.125, 4.525, 128, lindisp),
           jd(2.125, 4.525, 128, lindisp), atol=ATOL * 4.525)

"""The reference helpers that no trainer calls, held to the JAX package on
seeded inputs on the CPU: `ops/geometry.py`'s RayBatch builders and
`get_nearest_pose_ids`, `ops/homography.py`'s plane-sweep helpers and
`build_cost_volume`'s side outputs, `render/renderer.py`'s
`gen_angle_feature`, `eval/paths.py`'s `gen_render_path_pixelnerf` and
`utils/profiling.py`.

Tolerances, per test: exact where both sides run the same operations in
the same order (integer draws, gathers, masks, numpy paths); otherwise
1e-6 x (1 + max|JAX|), float32 sums (3-term matmuls, bilinear taps) in
another order.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_finetune import Scene
from torch_port_common import t

TOL = 1e-6
D_PLANES, PAD = 16, 2


def _close(ours, ref, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0,
                               atol=TOL * (1 + np.abs(ref).max()),
                               err_msg=what)


@pytest.fixture(scope="module")
def scene():
    s = Scene()
    imgs_norm, projs, near_far, pose = s.read_source_views()
    rng = np.random.default_rng(3)
    return dict(scene=s, imgs=s.imgs[:3], projs=projs, near_far=near_far,
                pose=pose, depth=rng.uniform(2.0, 6.0, (32, 32)).astype(
                    np.float32),
                feats=rng.standard_normal((3, 8, 8, 5)).astype(np.float32),
                depths=np.linspace(2.0, 6.0, D_PLANES).astype(np.float32))


# ------------------------------------------------------------ geometry ---

def _fields(batch):
    return {k: v for k, v in batch._asdict().items() if v is not None}


def test_build_rays_test_matches_jax(scene):
    """1e-6 x (1 + max|JAX|); the pixels exact."""
    from mvsnerf_tpu.ops.geometry import build_rays_test as jax_build
    from mvsnerf_tpu_torch.ops.geometry import build_rays_test
    p = scene["pose"]
    args = (np.linalg.inv(scene["scene"].w2cs[4]), p["w2cs"][0],
            p["intrinsics"][0], scene["near_far"], [2.5, 5.5], 12)
    ours = _fields(build_rays_test(32, 24, *(t(a) for a in args[:3]),
                                   t(args[3]), t(args[4]), 12, pad=4))
    ref = _fields(jax_build(32, 24, *(jnp.asarray(a, jnp.float32)
                                      for a in args[:5]), 12, pad=4))
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].shape == ref[k].shape, k
        _close(ours[k], ref[k], k)
    np.testing.assert_array_equal(ours["pixel_xy"], ref["pixel_xy"])


@pytest.mark.parametrize("precrop", [False, True])
def test_build_rays_train_matches_jax(scene, monkeypatch, precrop):
    """JAX takes the port's pixel draws (its random stream differs), at
    perturb 0: 1e-6 x (1 + max|JAX|), the gathered colours and depths and
    the pixels exact. With perturb, the port's depths are the stratified
    ones at the uniforms its generator draws after the pixels."""
    from mvsnerf_tpu.ops import geometry as jg
    from mvsnerf_tpu_torch.ops.geometry import build_rays_train, \
        sample_random_pixels
    p = scene["pose"]
    img, depth = t(scene["imgs"][1]), t(scene["depth"])
    cams = (np.linalg.inv(p["w2cs"][1]), p["w2cs"][0], p["intrinsics"][0])
    nf_t, nf_r = [2.2, 5.8], scene["near_far"]

    def port(perturb):
        gen = torch.Generator().manual_seed(7)
        return build_rays_train(gen, img, depth, t(p["intrinsics"][1]),
                                *(t(c) for c in cams), t(nf_t), t(nf_r),
                                n_rays=50, n_samples=12, pad=4,
                                precrop=precrop, perturb=perturb)

    ours = port(0.0)
    xs, ys = ours.pixel_xy[:, 0], ours.pixel_xy[:, 1]
    gen = torch.Generator().manual_seed(7)
    assert torch.equal(torch.stack(sample_random_pixels(
        32, 32, 50, gen, precrop=precrop), -1), ours.pixel_xy)
    monkeypatch.setattr(jg, "sample_random_pixels",
                        lambda *a, **k: (jnp.asarray(xs.numpy()),
                                         jnp.asarray(ys.numpy())))
    ref = _fields(jg.build_rays_train(
        jax.random.PRNGKey(0), jnp.asarray(scene["imgs"][1]),
        jnp.asarray(scene["depth"]), jnp.asarray(p["intrinsics"][1]),
        *(jnp.asarray(c, jnp.float32) for c in cams),
        jnp.asarray(nf_t), jnp.asarray(nf_r), 50, 12, pad=4,
        precrop=precrop, perturb=0.0))
    ours = _fields(ours)
    assert ours.keys() == ref.keys()
    for k in ("colors", "depths", "pixel_xy"):
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    for k in ref:
        _close(ours[k], ref[k], k)

    jit = port(1.0)
    gen = torch.Generator().manual_seed(7)
    sample_random_pixels(32, 32, 50, gen, precrop=precrop)
    u = torch.rand((50, 12), generator=gen)
    z = ours["z_vals"]
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    lower = torch.cat([z[:, :1], mids], -1)
    upper = torch.cat([mids, z[:, -1:]], -1)
    torch.testing.assert_close(jit.z_vals, lower + (upper - lower) * u,
                               rtol=0, atol=0)
    assert torch.equal(jit.pixel_xy, ours["pixel_xy"])


def test_get_nearest_pose_ids_is_stable_like_jax():
    """Exact, ties in index order (jnp.argsort is stable)."""
    from mvsnerf_tpu.ops.geometry import get_nearest_pose_ids as jax_ids
    from mvsnerf_tpu_torch.ops.geometry import get_nearest_pose_ids
    rng = np.random.default_rng(2)
    refs = rng.integers(-3, 4, (40, 3)).astype(np.float32)  # many ties
    tgt = np.zeros(3, np.float32)
    for k in (1, 5, 40):
        np.testing.assert_array_equal(
            get_nearest_pose_ids(t(tgt), t(refs), k).numpy(),
            np.asarray(jax_ids(jnp.asarray(tgt), jnp.asarray(refs), k)))


# ---------------------------------------------------------- homography ---

def test_plane_sweep_grid_warp_and_mask_match_jax(scene):
    """The grid and the warp 1e-6 x (1 + max|JAX|); the mask of JAX's grid
    exact."""
    from mvsnerf_tpu.ops import homography as jh
    from mvsnerf_tpu_torch.ops.homography import homo_warp, \
        in_bounds_mask, plane_sweep_grid
    pm, d = scene["projs"][1], scene["depths"]
    ref_grid = jh.plane_sweep_grid(jnp.asarray(pm), jnp.asarray(d), 8, 8,
                                   PAD)
    grid = plane_sweep_grid(t(pm), t(d), 8, 8, PAD)
    assert grid.shape == (D_PLANES, 12, 12, 2)
    _close(grid, ref_grid, "grid")
    np.testing.assert_array_equal(
        in_bounds_mask(t(np.asarray(ref_grid))).numpy(),
        np.asarray(jh.in_bounds_mask(ref_grid)))
    feat = scene["feats"][1]
    warped, g = homo_warp(t(feat), t(pm), t(d), PAD)
    ref_w, _ = jh.homo_warp(jnp.asarray(feat), jnp.asarray(pm),
                            jnp.asarray(d), PAD)
    assert torch.equal(g, grid)
    _close(warped, ref_w, "warp")
    # a given grid is used as it is
    again, g2 = homo_warp(t(feat), t(pm), t(d), PAD, grid=t(np.asarray(
        ref_grid)))
    _close(again, ref_w, "warp on JAX's grid")


def test_build_cost_volume_feat_matches_jax(scene):
    """1e-6 x (1 + max|JAX|); the mask count (from ones) exact."""
    from mvsnerf_tpu.ops.homography import build_cost_volume_feat as jax_b
    from mvsnerf_tpu_torch.ops.homography import build_cost_volume_feat
    args = (scene["feats"], scene["projs"], scene["depths"])
    var, masks = build_cost_volume_feat(*(t(a) for a in args), PAD)
    ref_var, ref_masks = jax_b(*(jnp.asarray(a) for a in args), PAD)
    assert var.shape == (D_PLANES, 12, 12, 5)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(ref_masks))
    assert masks.min() >= 1.0
    _close(var, ref_var, "variance")


def test_sweep_side_outputs_match_jax_build_cost_volume(scene):
    """`build_cost_volume`'s in_masks and colors in JAX (homography.py:
    491-500): masks exact, colours 1e-6 x (1 + max|JAX|)."""
    from mvsnerf_tpu.ops.homography import build_cost_volume as jax_build
    from mvsnerf_tpu_torch.ops.homography import sweep_side_outputs
    imgs, projs, d = scene["imgs"], scene["projs"], scene["depths"]
    feats = np.zeros((3, 8, 8, 4), np.float32)
    _, ref_masks, ref_colors = jax_build(
        jnp.asarray(imgs), jnp.asarray(feats), jnp.asarray(projs),
        jnp.asarray(d), pad=PAD, fast_warp=False)
    masks, colors = sweep_side_outputs(t(imgs), t(projs), t(d), PAD)
    assert colors.shape == (3, D_PLANES, 12, 12, 4)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(ref_masks))
    _close(colors, ref_colors, "colors")


# ----------------------------------------------------- renderer, paths ---

def test_gen_angle_feature_matches_jax():
    """1e-6 x (1 + max|JAX|)."""
    from mvsnerf_tpu.render.renderer import gen_angle_feature as jax_angle
    from mvsnerf_tpu_torch.render.renderer import gen_angle_feature
    rng = np.random.default_rng(4)
    c2ws = rng.standard_normal((3, 4, 4)).astype(np.float32)
    pts = rng.standard_normal((20, 7, 3)).astype(np.float32)
    dirs = rng.standard_normal((20, 3)).astype(np.float32)
    ours = gen_angle_feature(t(c2ws), t(pts), t(dirs))
    assert ours.shape == (20, 7, 3)
    _close(ours, jax_angle(*(jnp.asarray(a) for a in (c2ws, pts, dirs))))


@pytest.mark.parametrize("n_views", [3, 30, 60])
def test_gen_render_path_pixelnerf_matches_jax(n_views):
    """Exact: the same numpy and scipy operations."""
    from mvsnerf_tpu.eval.paths import gen_render_path_pixelnerf as jax_path
    from mvsnerf_tpu_torch.eval.paths import gen_render_path_pixelnerf
    c2w = np.eye(4)
    c2w[:3, 3] = [0.1, -0.2, 0.3]
    ours = gen_render_path_pixelnerf(c2w, n_views)
    np.testing.assert_array_equal(ours, jax_path(c2w, n_views))
    assert ours.shape == (max(n_views // 5, 1) * 6, 4, 4)


# ----------------------------------------------------------- profiling ---

def test_trace_context_lands_in_the_chrome_trace(tmp_path):
    from mvsnerf_tpu_torch.utils.profiling import profiler_trace, \
        trace_context
    with profiler_trace(str(tmp_path)) as prof:
        with trace_context("port_region"):
            torch.ones(64).sum()
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    with open(prof.trace_path) as f:
        assert "port_region" in f.read()


def test_enable_nan_debugging_toggles_anomaly_mode():
    from mvsnerf_tpu_torch.utils.profiling import enable_nan_debugging
    try:
        enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"), \
                pytest.warns(UserWarning, match="SqrtBackward"):
            torch.sqrt(x).sum().backward()
    finally:
        enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()

"""The colour-baked (`tiled`) render path of the port against the JAX
package, on the CPU, on a small 3-view scene (32x32 views, pad 4, a
(16, 16, 16, 8) random encoding volume, 16 samples):

- `frustum_point_volume` and `bake_color_volume` against JAX's
  (abs <= 1e-5 x the magnitude: ~1e-6 for points, colours in [0, 1]);
- the tiled renderer (K6b's twin over the baked volume) against JAX's
  exact path on the same volume, `render_rays(use_color_volume=True)`
  (rgb, acc abs <= 1e-5; depth abs <= 5e-5);
- K6b's twin against JAX's interpret-mode Pallas `tiled_render_v0` with
  float32 interpolation, the 'highest' MLP and no early stop (the same
  tolerances; the TPU default, bf16 with early stop, differs from the
  exact path by up to 6e-2);
- `cached_tiled_renderer` bakes again after an in-place volume update.
The CUDA kernel is held against its twin on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import jax_params, port_modules, t

H = W = 32
PAD, D, N_SAMPLES = 4, 16, 16
NEAR_FAR = (2.0, 6.0)
RNG = np.random.default_rng(21)


def _scene():
    intr = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]],
                    np.float32)
    w2cs = []
    for i in range(3):
        a = 0.06 * (i - 1)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]]
        m[:3, 3] = [0.2 * (i - 1), 0.02 * i, 0]
        w2cs.append(m)
    w2cs = np.stack(w2cs)
    return {"imgs": RNG.uniform(0, 1, (3, H, W, 3)).astype(np.float32),
            "w2cs": w2cs, "c2ws": np.linalg.inv(w2cs).astype(np.float32),
            "intrinsics": np.stack([intr] * 3),
            "volume": RNG.standard_normal(
                (D, H // 4 + 2 * PAD, W // 4 + 2 * PAD, 8)).astype(
                    np.float32)}


@pytest.fixture(scope="module")
def case():
    from mvsnerf_tpu.data.dtu_ft import rays_for_pose
    from mvsnerf_tpu.render.tiled import bake_color_volume
    sc = _scene()
    pose = {k: jnp.asarray(sc[k]) for k in ("w2cs", "c2ws", "intrinsics")}
    vol20 = np.asarray(bake_color_volume(
        jnp.asarray(sc["volume"]), jnp.asarray(sc["imgs"]), pose,
        np.asarray(NEAR_FAR, np.float32), PAD))
    # a target view between the sources, off their pixel grids
    c2w = np.linalg.inv(sc["w2cs"][1]).copy()
    c2w[:3, 3] += [0.05, -0.03, 0.0]
    rays = rays_for_pose(H, W, [40.0, 40.0], [W / 2 + 0.3, H / 2 + 0.2],
                         c2w, *NEAR_FAR)
    return dict(sc, vol20=vol20, rays=rays, params=jax_params(3))


def _port_pose(case, with_c2ws=False):
    keys = ("w2cs", "c2ws", "intrinsics") if with_c2ws else \
        ("w2cs", "intrinsics")
    return {k: t(case[k]) for k in keys}


@pytest.mark.parametrize("with_c2ws", [True, False])
def test_bake_matches_jax(case, with_c2ws):
    from mvsnerf_tpu_torch.render.tiled import bake_color_volume
    vol20 = bake_color_volume(t(case["volume"]), t(case["imgs"]),
                              _port_pose(case, with_c2ws), t(NEAR_FAR), PAD)
    assert vol20.shape == case["vol20"].shape == (D, 16, 16, 20)
    np.testing.assert_array_equal(vol20[..., :8].numpy(), case["volume"])
    # both masks and colours: in-image samples must agree exactly on the
    # mask; a voxel on a view's border may flip it by an ulp
    diff = np.abs(vol20.numpy() - case["vol20"])
    assert (diff > 1e-5).mean() < 1e-3
    assert 0.1 < case["vol20"][..., 11].mean() < 0.99  # masks not trivial


def test_frustum_points_match_jax(case):
    from mvsnerf_tpu.train.finetune import frustum_point_volume as jax_fpv
    from mvsnerf_tpu_torch.train.finetune import frustum_point_volume
    intr_s4 = case["intrinsics"][0].copy()
    intr_s4[:2] /= 4
    ref = np.asarray(jax_fpv(8, 8, D, PAD, jnp.asarray(NEAR_FAR),
                             jnp.asarray(intr_s4),
                             jnp.asarray(case["c2ws"][0])))
    ours = frustum_point_volume(8, 8, D, PAD, t(NEAR_FAR), t(intr_s4),
                                t(case["c2ws"][0])).numpy()
    assert ours.shape == ref.shape == (D, 16, 16, 3)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    # plane 0 at near, the last at far (the volume's plane order)
    z_cam = lambda p: (p.reshape(-1, 3) @ case["w2cs"][0][:3, :3].T +
                       case["w2cs"][0][:3, 3])[:, 2]
    np.testing.assert_allclose(z_cam(ours[0]), NEAR_FAR[0], atol=1e-5)
    np.testing.assert_allclose(z_cam(ours[-1]), NEAR_FAR[1], atol=1e-5)


def _jax_exact_baked(case, white_bkgd=False):
    """JAX's exact render over its baked volume (evaluate.py's protocol:
    unjittered samples, NDC scaled by the source views' size)."""
    from mvsnerf_tpu.ops.geometry import get_ndc_coordinate
    from mvsnerf_tpu.ops.sampling import ray_marcher
    from mvsnerf_tpu.render.renderer import render_rays
    pts, _, rays_d, z = ray_marcher(jax.random.PRNGKey(0),
                                    jnp.asarray(case["rays"]), N_SAMPLES,
                                    perturb=0.0)
    w2c = jnp.asarray(case["w2cs"][0])
    ndc = get_ndc_coordinate(w2c, jnp.asarray(case["intrinsics"][0]), pts,
                             jnp.asarray([W - 1.0, H - 1.0]),
                             near=NEAR_FAR[0], far=NEAR_FAR[1], pad=PAD)
    out = render_rays(case["params"][0], jnp.asarray(case["vol20"]), None,
                      ndc, z, rays_d, w2c_ref=w2c, use_color_volume=True,
                      white_bkgd=white_bkgd)
    return {k: np.asarray(out[k]) for k in ("rgb", "depth", "acc")}, \
        np.asarray(ndc), np.asarray(z), np.asarray(rays_d)


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_tiled_renderer_matches_jax_exact_baked(case, white_bkgd):
    from mvsnerf_tpu_torch.render.tiled import make_tiled_renderer
    ref = _jax_exact_baked(case, white_bkgd)[0]
    mlp, _ = port_modules(*case["params"])
    render = make_tiled_renderer(
        mlp, torch.tensor(case["vol20"]), t(case["imgs"]), t(NEAR_FAR),
        _port_pose(case), N_SAMPLES, PAD, white_bkgd=white_bkgd, chunk=300)
    with torch.no_grad():
        out = render(t(case["rays"]), H, W)
    assert 0.05 < ref["acc"].mean() < 0.999
    for k, tol in (("rgb", 1e-5), ("acc", 1e-5), ("depth", 5e-5)):
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=0, atol=tol,
                                   err_msg=k)


def test_tiled_renderer_bakes_an_8_channel_volume(case):
    """Given the 8-channel volume, the renderer bakes it itself, to the
    volume JAX bakes."""
    from mvsnerf_tpu_torch.render.tiled import make_tiled_renderer
    mlp, _ = port_modules(*case["params"])
    render = make_tiled_renderer(mlp, t(case["volume"]), t(case["imgs"]),
                                 t(NEAR_FAR), _port_pose(case), N_SAMPLES,
                                 PAD)
    assert render.volume.shape == (D, 16, 16, 20)
    assert (np.abs(render.volume.numpy() - case["vol20"]) > 1e-5).mean() \
        < 1e-3


def test_k6b_twin_matches_jax_interpret_kernel(case):
    """K6b's twin against the Pallas kernel itself (interpret mode) at
    f32 interpolation, 'highest' MLP precision and no early stop, on an
    image that tiles by (4, 8) and stays inside its windows."""
    from mvsnerf_tpu.ops import pallas_render_tiled as prt
    from mvsnerf_tpu_torch.ops.render_fused import render_v0
    rng = np.random.default_rng(5)
    dims, ih, iw, s = (16, 16, 16), 8, 16, 32
    vol = rng.standard_normal((*dims, 20)).astype(np.float32) * 0.5
    px = np.tile(np.arange(iw), ih).astype(np.float32)
    py = np.repeat(np.arange(ih), iw).astype(np.float32)
    jit = rng.uniform(-0.3, 0.3, (2, ih * iw, s)).astype(np.float32)
    x = ((px[:, None] + jit[0]) / (iw - 1)).clip(-0.05, 1.05)
    y = ((py[:, None] + jit[1]) / (ih - 1)).clip(-0.05, 1.05)
    z = np.broadcast_to(np.linspace(0, 1, s, dtype=np.float32),
                        (ih * iw, s))
    xyz = np.stack([x, y, z], -1).astype(np.float32)
    zv = (2 + 4 * z).astype(np.float32)
    dirs = rng.standard_normal((ih * iw, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    mlp_p = case["params"][0]
    ref = prt.render_image_tiled(
        mlp_p, prt.prepare_volume(jnp.asarray(vol), dtype=jnp.float32),
        jnp.asarray(xyz), jnp.asarray(dirs), jnp.asarray(zv),
        image_hw=(ih, iw), dims=dims, tile_hw=(4, 8),
        mlp_precision="highest", interp_dtype="float32", early_stop=0.0,
        interpret=True, yb=16, kb=8, xb=16)
    mlp, _ = port_modules(*case["params"])
    with torch.no_grad():
        out = render_v0(t(xyz), t(zv), None, t(dirs), t(vol), mlp)
    assert 0.05 < float(np.asarray(ref["acc"]).mean()) < 0.999
    for k, tol in (("rgb", 1e-5), ("acc", 1e-5), ("depth", 5e-5)):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=tol, err_msg=k)


def test_cached_renderer_rebakes_after_in_place_update(case):
    from types import SimpleNamespace

    from mvsnerf_tpu_torch.render.tiled import cached_tiled_renderer
    mlp, _ = port_modules(*case["params"])
    volume = torch.nn.Parameter(t(case["volume"]))
    system = SimpleNamespace(mlp=mlp)
    kw = dict(n_samples=N_SAMPLES, pad=PAD)
    args = (t(case["imgs"]), t(NEAR_FAR), _port_pose(case))
    first = cached_tiled_renderer(system, volume, *args, **kw)
    assert cached_tiled_renderer(system, volume, *args, **kw) is first
    before = first.volume.clone()
    # Adam updates the trainable volume in place: same object, new version
    opt = torch.optim.Adam([volume], lr=0.1)
    volume.grad = torch.ones_like(volume)
    opt.step()
    second = cached_tiled_renderer(system, volume, *args, **kw)
    assert second is not first
    np.testing.assert_allclose(second.volume[..., :8].detach().numpy(),
                               before[..., :8].numpy() - 0.1, atol=1e-5)
    np.testing.assert_array_equal(second.volume[..., 8:].numpy(),
                                  before[..., 8:].numpy())
    with torch.no_grad():
        volume.add_(1.0)
    assert cached_tiled_renderer(system, volume, *args, **kw) is not second
    # another tensor of the same values is another volume
    other = volume.detach().clone()
    third = cached_tiled_renderer(system, other, *args, **kw)
    assert third is not second
    # another chunk size is another renderer, not the first call's
    assert cached_tiled_renderer(system, other, *args, chunk=64,
                                 **kw) is not third

"""The whole no-finetune slice of the port against the JAX package, on the
toy scene of `__graft_entry__._toy_scene` (64x96, pad 4, 16 planes) with
256 rays x 32 samples, on the CPU.

The JAX reference is `entry()`'s forward (MVSNet volume -> rays from
pixels -> render_rays), with `warp_mode="packed"`, `costreg_impl="plain"`
and `featurenet_impl="plain"` so that no TPU layout takes part, and with
the evaluator's image convention: MVSNet reads ImageNet-normalised views
and the renderer their un-normalised colours. The port goes through
`Evaluator.build_volume` + `Evaluator.render` in both modes. Tolerances:
volume abs <= 1e-4 * (1 + max|ref|), rgb abs <= 1e-4."""

import numpy as np
import pytest

import jax.numpy as jnp

from torch_port_common import jax_params, port_modules, \
    port_modules_via_checkpoint

N_RAYS, N_SAMPLES, NEAR_FAR = 256, 32, (2.0, 6.0)
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


@pytest.fixture(scope="module")
def case():
    from __graft_entry__ import _toy_scene
    imgs, intr, w2cs, projs, pad, n_planes = _toy_scene()
    imgs_norm = (np.asarray(imgs) - MEAN) / STD
    rng = np.random.default_rng(1)
    h, w = imgs.shape[1:3]
    xs = rng.uniform(0, w - 1, N_RAYS).astype(np.float32)
    ys = rng.uniform(0, h - 1, N_RAYS).astype(np.float32)
    params = jax_params(0)
    return dict(imgs_norm=imgs_norm.astype(np.float32),
                intr=np.asarray(intr), w2cs=np.asarray(w2cs),
                projs=np.asarray(projs), pad=pad, n_planes=n_planes, xs=xs,
                ys=ys, params=params, ref=_jax_forward(params, imgs_norm,
                                                       intr, w2cs, projs, pad,
                                                       n_planes, xs, ys))


def _jax_forward(params, imgs_norm, intr, w2cs, projs, pad, n_planes, xs,
                 ys):
    """entry()'s forward with the plain TPU-layout-free implementations."""
    from mvsnerf_tpu.models import mvsnet_apply
    from mvsnerf_tpu.ops import get_ndc_coordinate, rays_from_pixels
    from mvsnerf_tpu.render import render_rays
    from mvsnerf_tpu.train.common import unpreprocess_images
    mlp_p, mvs_p = params
    v, h, w, _ = imgs_norm.shape
    near_far = jnp.asarray(NEAR_FAR)
    imgs_norm = jnp.asarray(imgs_norm)
    volume = mvsnet_apply(mvs_p, imgs_norm, jnp.asarray(projs), near_far,
                          pad=pad, n_planes=n_planes, warp_mode="packed",
                          costreg_impl="plain", featurenet_impl="plain")[0]
    c2w = jnp.linalg.inv(jnp.asarray(w2cs[0]))
    rays_o, rays_d = rays_from_pixels(jnp.asarray(xs), jnp.asarray(ys),
                                      jnp.asarray(intr), c2w)
    tt = jnp.linspace(0.0, 1.0, N_SAMPLES)
    z_vals = jnp.broadcast_to(near_far[0] * (1 - tt) + near_far[1] * tt,
                              (N_RAYS, N_SAMPLES))
    pts = rays_o[None, None] + z_vals[..., None] * rays_d[:, None]
    pts_ndc = get_ndc_coordinate(jnp.asarray(w2cs[0]), jnp.asarray(intr),
                                 pts, jnp.asarray([w - 1.0, h - 1.0]),
                                 near=near_far[0], far=near_far[1], pad=pad)
    out = render_rays(mlp_p, volume, pts, pts_ndc, z_vals, rays_d,
                      w2c_ref=jnp.asarray(w2cs[0]),
                      w2cs=jnp.asarray(w2cs),
                      intrinsics=jnp.broadcast_to(jnp.asarray(intr),
                                                  (v, 3, 3)),
                      imgs=unpreprocess_images(imgs_norm))
    rays = np.concatenate(
        [np.broadcast_to(np.asarray(rays_o), (N_RAYS, 3)),
         np.asarray(rays_d), np.full((N_RAYS, 1), NEAR_FAR[0]),
         np.full((N_RAYS, 1), NEAR_FAR[1])], -1).astype(np.float32)
    return {"volume": np.asarray(volume), "rgb": np.asarray(out["rgb"]),
            "depth": np.asarray(out["depth"]), "rays": rays}


def _port_run(case, mlp, mvsnet):
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator
    ev = Evaluator(mvsnet, mlp, n_samples=N_SAMPLES, pad=case["pad"],
                   n_planes=case["n_planes"], chunk=100, device="cpu")
    volume, *_ = ev.build_volume(
        case["imgs_norm"], case["projs"], NEAR_FAR,
        {"w2cs": case["w2cs"], "intrinsics": np.stack([case["intr"]] * 3)})
    outs = {m: ev.render(case["ref"]["rays"], 16, 16, mode=m)
            for m in ("chunked", "hybrid")}
    return volume.numpy(), outs


@pytest.fixture(scope="module")
def port(case):
    return _port_run(case, *port_modules(*case["params"]))


def test_slice_volume_matches_jax(case, port):
    ref = case["ref"]["volume"]
    assert port[0].shape == ref.shape == (16, 24, 32, 8)
    np.testing.assert_allclose(port[0], ref, rtol=0,
                               atol=1e-4 * (1 + np.abs(ref).max()))


@pytest.mark.parametrize("mode", ["chunked", "hybrid"])
def test_slice_render_matches_jax(case, port, mode):
    out = port[1][mode]
    assert out["rgb"].shape == (N_RAYS, 3)
    np.testing.assert_allclose(out["rgb"].numpy(), case["ref"]["rgb"],
                               rtol=0, atol=1e-4)
    # depth ~ 2..6: the same relative tolerance
    np.testing.assert_allclose(out["depth"].numpy(), case["ref"]["depth"],
                               rtol=0, atol=6e-4)


def test_slice_weight_routes_agree(case, port, tmp_path):
    """Weights through a reference checkpoint on disk give the identical
    slice output."""
    other = _port_run(case, *port_modules_via_checkpoint(
        *case["params"], tmp_path / "ck.tar"))
    np.testing.assert_array_equal(other[0], port[0])
    for mode in ("chunked", "hybrid"):
        np.testing.assert_array_equal(other[1][mode]["rgb"].numpy(),
                                      port[1][mode]["rgb"].numpy())


def test_evaluator_rejects_bad_requests(case):
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator
    mlp, mvsnet = port_modules(*case["params"])
    ev = Evaluator(mvsnet, mlp, n_samples=8, pad=case["pad"], n_planes=8,
                   device="cpu")
    with pytest.raises(RuntimeError):
        ev.render(case["ref"]["rays"], 16, 16)
    ev.build_volume(case["imgs_norm"], case["projs"], NEAR_FAR,
                    {"w2cs": case["w2cs"],
                     "intrinsics": np.stack([case["intr"]] * 3)})
    for mode in ("chunked", "hybrid", "tiled"):
        with pytest.raises(ValueError):
            ev.render(case["ref"]["rays"], 16, 15, mode=mode)
    with pytest.raises(ValueError):
        ev.render(case["ref"]["rays"], 16, 16, mode="exact")



def test_slice_outputs_are_not_trivial(case, port):
    """Guards the parity tests above against a degenerate scene."""
    assert np.abs(case["ref"]["volume"]).mean() > 0.1
    acc = port[1]["chunked"]["acc"].numpy()
    assert 0.05 < acc.mean() < 0.999
    assert case["ref"]["rgb"].std() > 1e-3


def test_evaluator_white_background(case, port):
    """white_bkgd composites rgb + (1 - acc) in both modes."""
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator
    mlp, mvsnet = port_modules(*case["params"])
    ev = Evaluator(mvsnet, mlp, n_samples=N_SAMPLES, pad=case["pad"],
                   n_planes=case["n_planes"], white_bkgd=True, device="cpu")
    ev.build_volume(case["imgs_norm"], case["projs"], NEAR_FAR,
                    {"w2cs": case["w2cs"],
                     "intrinsics": np.stack([case["intr"]] * 3)})
    for mode in ("chunked", "hybrid"):
        out = ev.render(case["ref"]["rays"], 16, 16, mode=mode)
        black = port[1][mode]
        np.testing.assert_allclose(
            out["rgb"].numpy(),
            (black["rgb"] + (1 - black["acc"][:, None])).numpy(),
            rtol=0, atol=1e-5)

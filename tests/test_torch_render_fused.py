"""K6's plain twin (volume fetch + PE + v0 MLP + compositing) against the
JAX package's `render_rays` on its exact `index_point_feature` path, on
the CPU. Both get the same colours (JAX's own `build_color_volume`), so
the comparison isolates K6. Tolerance: rgb, depth and acc abs <= 1e-5
(depth scaled by its ~5 magnitude). The CUDA kernel itself is held against
this twin on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_common import jax_params, port_modules, t

RNG = np.random.default_rng(9)


def _case(n_rays=96, n_samples=24, d=16, hp=24, wp=32):
    volume = RNG.standard_normal((d, hp, wp, 8)).astype(np.float32)
    imgs = RNG.uniform(0, 1, (3, 40, 56, 3)).astype(np.float32)
    intr = np.array([[60.0, 0, 28], [0, 60.0, 20], [0, 0, 1]], np.float32)
    w2cs = np.stack([np.eye(4, dtype=np.float32)] * 3)
    w2cs[:, 0, 3] = [-0.2, 0.0, 0.2]
    rays_d = np.concatenate([RNG.uniform(-0.4, 0.4, (n_rays, 2)),
                             np.ones((n_rays, 1))], -1).astype(np.float32)
    z = np.broadcast_to(np.linspace(2.0, 5.0, n_samples, dtype=np.float32),
                        (n_rays, n_samples)).copy()
    pts = (rays_d[:, None] * z[..., None]).astype(np.float32)
    return volume, imgs, intr, w2cs, rays_d, z, pts


@pytest.mark.parametrize("seed", [0, 1])
def test_render_twin_matches_jax_render_rays(seed):
    from mvsnerf_tpu.ops.geometry import get_ndc_coordinate
    from mvsnerf_tpu.render.renderer import (build_color_volume,
                                             gen_dir_feature, render_rays)
    from mvsnerf_tpu_torch.ops.render_fused import render_v0
    mlp_p, mvs_p = jax_params(seed)
    volume, imgs, intr, w2cs, rays_d, z, pts = _case()
    intrs = np.stack([intr] * 3)
    ndc = np.asarray(get_ndc_coordinate(
        jnp.asarray(w2cs[0]), jnp.asarray(intr), jnp.asarray(pts),
        jnp.asarray([55.0, 39.0]), near=2.0, far=5.0, pad=4))
    ref = render_rays(mlp_p, jnp.asarray(volume), jnp.asarray(pts),
                      jnp.asarray(ndc), jnp.asarray(z), jnp.asarray(rays_d),
                      w2c_ref=jnp.asarray(w2cs[0]), w2cs=jnp.asarray(w2cs),
                      intrinsics=jnp.asarray(intrs), imgs=jnp.asarray(imgs))
    colors = np.asarray(build_color_volume(
        jnp.asarray(pts), jnp.asarray(w2cs), jnp.asarray(intrs),
        jnp.asarray(imgs), mode="gather"))
    unit = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    dirs = np.asarray(gen_dir_feature(jnp.asarray(w2cs[0]),
                                      jnp.asarray(unit)))
    mlp, _ = port_modules(mlp_p, mvs_p)
    with torch.no_grad():
        out = render_v0(t(ndc), t(z), t(colors), t(dirs), t(volume), mlp)
    acc = np.asarray(ref["acc"])
    assert 0.05 < acc.mean() < 0.999  # the rays see non-trivial density
    np.testing.assert_allclose(out["rgb"].numpy(), np.asarray(ref["rgb"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["acc"].numpy(), acc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["depth"].numpy(),
                               np.asarray(ref["depth"]), rtol=0, atol=5e-5)


def test_pack_v0_weights_layout():
    """The kernel's packed weights: each layer (in, out) row-major, then
    its bias, in csrc/render_v0.cu's order."""
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.ops.render_fused import N_WEIGHTS, \
        pack_v0_weights
    mlp = MVSNeRF()
    w = pack_v0_weights(mlp)
    assert w.shape == (N_WEIGHTS,) and N_WEIGHTS == 126788
    n = mlp.nerf
    l0 = n.pts_linears[0]
    assert torch.equal(w[:63 * 128].reshape(63, 128), l0.weight.T)
    assert torch.equal(w[63 * 128:64 * 128], l0.bias)
    assert torch.equal(w[-3:], n.rgb_linear.bias)
    assert torch.equal(w[-3 - 192:-3].reshape(64, 3), n.rgb_linear.weight.T)


def test_render_wrapper_rejects_other_devices():
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.ops.render_fused import render_v0
    m = "meta"
    with pytest.raises(ValueError, match="no kernel"):
        render_v0(torch.empty(4, 8, 3, device=m), torch.empty(4, 8, device=m),
                  torch.empty(4, 8, 12, device=m), torch.empty(4, 3, device=m),
                  torch.empty(4, 4, 4, 8, device=m), MVSNeRF())

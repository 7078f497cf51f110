"""K8's plain twin (PE + v0 MLP + compositing from gathered features)
against the JAX package's Pallas kernel `fused_render_v0` run in interpret
mode on the CPU, for all four outputs, on a ray count that is not a
multiple of the TPU kernel's 64-ray tile (it pads; the port does not).
Tolerance: rgb, acc and weights abs <= 1e-5, depth abs <= 5e-5 (depths
~2-6; the JAX kernel sums log-transmittances where the port multiplies).
The CUDA kernel itself is held against this twin on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_common import jax_params, port_modules, t


def _case(seed, n_rays, n_samples=16):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 1, (n_rays, n_samples, 3)).astype(np.float32)
    feats = rng.standard_normal((n_rays, n_samples, 20)).astype(np.float32)
    dirs = rng.standard_normal((n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2, 6, (n_rays, n_samples)), -1).astype(
        np.float32)
    return xyz, feats, dirs, z


@pytest.mark.parametrize("seed,n_rays", [(0, 100), (1, 37)])
def test_fused_feats_twin_matches_jax_kernel(seed, n_rays):
    from mvsnerf_tpu.ops.pallas_kernels import fused_render_v0, \
        pack_v0_weights
    from mvsnerf_tpu_torch.ops.render_fused import render_v0_feats
    mlp_p, mvs_p = jax_params(seed)
    xyz, feats, dirs, z = _case(seed, n_rays)
    ref = fused_render_v0(pack_v0_weights(mlp_p), jnp.asarray(xyz),
                          jnp.asarray(feats), jnp.asarray(dirs),
                          jnp.asarray(z), rays_per_tile=64, interpret=True)
    mlp, _ = port_modules(mlp_p, mvs_p)
    with torch.no_grad():
        out = render_v0_feats(t(xyz), t(feats), t(dirs), t(z), mlp)
    assert set(out) == {"rgb", "depth", "acc", "weights"}
    acc = np.asarray(ref["acc"])
    assert 0.05 < acc.mean() < 0.999  # the rays see non-trivial density
    assert out["weights"].shape == (n_rays, 16)
    for k, tol in (("rgb", 1e-5), ("acc", 1e-5), ("weights", 1e-5),
                   ("depth", 5e-5)):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=tol, err_msg=k)


def test_fused_feats_twin_is_the_unfused_render():
    """The twin equals the port's own chunked render steps: network_input,
    the module's MLP, raw2outputs."""
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.ops.compositing import raw2outputs
    from mvsnerf_tpu_torch.ops.render_fused import render_v0_feats_plain
    from mvsnerf_tpu_torch.render.renderer import network_input
    torch.manual_seed(0)
    mlp = MVSNeRF()
    xyz, feats, dirs, z = (t(a) for a in _case(2, 12, 8))
    with torch.no_grad():
        out = render_v0_feats_plain(xyz, feats, dirs, z, mlp)
        ref = raw2outputs(mlp(network_input(xyz, dirs, feats)), z)
    for k in out:
        assert torch.equal(out[k], ref[k]), k


def test_fused_feats_wrapper_rejects_other_devices():
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.ops.render_fused import render_v0_feats
    m = "meta"
    with pytest.raises(ValueError, match="no kernel"):
        render_v0_feats(torch.empty(4, 8, 3, device=m),
                        torch.empty(4, 8, 20, device=m),
                        torch.empty(4, 3, device=m),
                        torch.empty(4, 8, device=m), MVSNeRF())

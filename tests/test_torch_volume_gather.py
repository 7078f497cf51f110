"""K5's plain route (trilinear fetch from the trainable volume, and its
gradients with respect to the volume and the NDC) against the JAX
package's `index_point_feature` under `jax.grad`, on the CPU, with samples
outside the volume included. The CUDA kernel itself is held against this
twin on the card by chip_smoke.py.

Tolerances: forward abs <= 1e-5; gradients abs <= 1e-4 x (1 + max|g|).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import t

D, HV, WV, C = 16, 24, 14, 8


def _case(seed, n=48, s=20):
    rng = np.random.default_rng(seed)
    volume = rng.standard_normal((D, HV, WV, C)).astype(np.float32)
    # [-0.1, 1.1]: about a quarter of the samples have corners outside
    ndc = rng.uniform(-0.1, 1.1, (n, s, 3)).astype(np.float32)
    g = rng.standard_normal((n, s, C)).astype(np.float32)
    return volume, ndc, g


def _jax_ref(volume, ndc, g):
    from mvsnerf_tpu.ops.interp import index_point_feature

    def f(v, nd):
        return jnp.sum(index_point_feature(v, nd) * g)

    out = index_point_feature(jnp.asarray(volume), jnp.asarray(ndc))
    gv, gn = jax.grad(f, argnums=(0, 1))(jnp.asarray(volume),
                                         jnp.asarray(ndc))
    return np.asarray(out), np.asarray(gv), np.asarray(gn)


def _close(a, b, scale):
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=1e-4 * (1 + np.abs(scale).max()))


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_volume_matches_jax(seed):
    from mvsnerf_tpu_torch.ops.volume_gather import sample_volume
    volume, ndc, g = _case(seed)
    ref, ref_gv, ref_gn = _jax_ref(volume, ndc, g)
    assert (np.abs(ref).sum(-1) == 0).mean() > 0.05  # zeros padding hit
    v, nd = t(volume).requires_grad_(), t(ndc).requires_grad_()
    out = sample_volume(v, nd)
    gv, gn = torch.autograd.grad(out, (v, nd), t(g))
    assert out.shape == (48, 20, C)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-5)
    _close(gv.numpy(), ref_gv, ref_gv)
    _close(gn.numpy(), ref_gn, ref_gn)


def test_volume_splat_twin_matches_jax():
    """The backward's own plain twin (what the card's splat is held
    against) is the JAX volume gradient."""
    from mvsnerf_tpu_torch.ops.volume_gather import volume_splat_plain
    volume, ndc, g = _case(2)
    _, ref_gv, _ = _jax_ref(volume, ndc, g)
    gv = volume_splat_plain(t(g), t(ndc), t(volume))
    assert gv.shape == volume.shape
    _close(gv.numpy(), ref_gv, ref_gv)


def test_sample_volume_rejects_other_devices():
    from mvsnerf_tpu_torch.ops.volume_gather import sample_volume
    with pytest.raises(ValueError, match="no kernel"):
        sample_volume(torch.empty(4, 4, 4, 8, device="meta"),
                      torch.empty(2, 3, 3, device="meta"))


def _stratified_ndc(seed, n_rays=8, n_samples=16):
    """Per-ray stratified z (what keeps each sample column inside the
    dense TPU kernel's z band), x and y anywhere in [-0.1, 1.1]."""
    rng = np.random.default_rng(seed)
    edges = np.linspace(0, 1, n_samples + 1)
    z = edges[:-1] + (edges[1:] - edges[:-1]) * rng.uniform(
        size=(n_rays, n_samples))
    xy = rng.uniform(-0.1, 1.1, (n_rays, n_samples, 2))
    return np.concatenate([xy, z[..., None]], -1).astype(np.float32)


def test_k5_twin_matches_jax_k9_kernel():
    """K9 (`sample_volume_pallas`, the dense one-hot gather and splat, run
    in interpret mode as tests/test_pallas_volgather.py runs it) computes
    K5's function: the port's K5 route against it at C=8 in float32,
    forward (abs <= 1e-5) and the volume and NDC gradients (abs <= 1e-4 x
    (1 + max|g|))."""
    from mvsnerf_tpu.ops.pallas_volgather import sample_volume_pallas
    from mvsnerf_tpu_torch.ops.volume_gather import sample_volume
    rng = np.random.default_rng(11)
    volume = rng.standard_normal((16, 12, 14, 8)).astype(np.float32)
    ndc = _stratified_ndc(3)
    g = rng.standard_normal((8, 16, 8)).astype(np.float32)

    def f(v, nd):
        return jnp.sum(sample_volume_pallas(v, nd, 4) * g)

    ref = np.asarray(sample_volume_pallas(jnp.asarray(volume),
                                          jnp.asarray(ndc), 4))
    ref_gv, ref_gn = (np.asarray(a) for a in jax.grad(f, argnums=(0, 1))(
        jnp.asarray(volume), jnp.asarray(ndc)))
    v, nd = t(volume).requires_grad_(), t(ndc).requires_grad_()
    out = sample_volume(v, nd)
    gv, gn = torch.autograd.grad(out, (v, nd), t(g))
    assert (np.abs(ref).sum(-1) == 0).mean() > 0.02  # zeros padding hit
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-5)
    _close(gv.numpy(), ref_gv, ref_gv)
    _close(gn.numpy(), ref_gn, ref_gn)

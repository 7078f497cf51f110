"""K1's plain twin (the port's build_cost_volume on the CPU) against the
JAX package's cost volume, at the shapes of tests/test_pallas_sweep2.py.

The reference is JAX `build_cost_volume(warp_fwd_mode="packed")` (dense
layout), and JAX's Pallas sweep path in interpret mode. Tolerance: abs <=
1e-5 * (1 + max|ref|), not the plain 1e-5: the variance channels reach
|5| here, where one f32 ulp is ~5e-7, and E[x^2] - E[x]^2 cancels after
per-view sums taken in another order (measured: 67 of 2e5 values off by
up to 3.3e-5, relative 7e-6). The CUDA kernel itself is held against this
twin on the card by chip_smoke.py, at the same tolerance."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_common import t

RNG = np.random.default_rng(11)
H, W, C, D, PAD, V = 24, 40, 8, 8, 4, 3


def _scene(d=D):
    """tests/test_pallas_sweep2.py's near-rectified 3-view sweep scene."""
    feats = RNG.standard_normal((V, H, W, C)).astype(np.float32)
    imgs = RNG.uniform(0, 1, (V, 4 * H, 4 * W, 3)).astype(np.float32)
    intr = np.array([[1.2 * W, 0, W / 2], [0, 1.2 * W, H / 2], [0, 0, 1]],
                    np.float32)
    ref4 = np.eye(4, dtype=np.float32)
    ref4[:3] = intr @ np.eye(4)[:3]
    ref_inv = np.linalg.inv(ref4)
    projs = []
    for i in range(V):
        a = 0.03 * (i - 1)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = R
        w2c[:3, 3] = [0.013 * i + 0.007, 0.003, 0.0]
        p4 = np.eye(4, dtype=np.float32)
        p4[:3] = intr @ w2c[:3]
        projs.append((p4 @ ref_inv)[:3])
    depths = np.linspace(2.0, 5.0, d).astype(np.float32)
    return feats, imgs, np.stack(projs).astype(np.float32), depths


def _close(out, ref):
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * (1.0 + np.abs(ref).max()))


def _port_cost(feats, imgs, projs, depths):
    from mvsnerf_tpu_torch.ops.homography import build_cost_volume
    return build_cost_volume(t(imgs), t(feats), t(projs), t(depths),
                             pad=PAD)


def _jax_cost(feats, imgs, projs, depths, **kw):
    from mvsnerf_tpu.ops.homography import build_cost_volume
    return np.asarray(build_cost_volume(
        jnp.asarray(imgs), jnp.asarray(feats), jnp.asarray(projs),
        jnp.asarray(depths), pad=PAD, **kw)[0])


def test_sweep_twin_matches_jax_dense():
    scene = _scene()
    ref = _jax_cost(*scene, warp_fwd_mode="packed")
    out = _port_cost(*scene)
    assert out.shape == ref.shape == (D, H + 2 * PAD, W + 2 * PAD,
                                      3 * V + C)
    _close(out, ref)


def test_sweep_twin_matches_jax_pallas_interpret():
    """JAX's Pallas sweep (the TPU kernel K1 replaces), run in interpret
    mode on the CPU."""
    scene = _scene(d=4)
    ref = _jax_cost(*scene, warp_fwd_mode="pallas", warp_band=16)
    _close(_port_cost(*scene), ref)


def test_cost_volume_feeds_costregnet_without_copy():
    """K3's port: the sweep writes the layout cuDNN runs the 3-D U-Net in
    (NCDHW), so the (1, 41, D, hp, wp) tensor needs no relayout and
    build_cost_volume's (D, hp, wp, 41) view of it permutes back to it."""
    from mvsnerf_tpu_torch.ops.sweep import sweep_cost_volume
    srcs = torch.randn(3, 12, 16, 35, generator=torch.Generator()
                       .manual_seed(0))
    projs = t(_scene()[2])
    cost = sweep_cost_volume(srcs, projs, torch.linspace(2, 5, 8), 2, 32)
    assert cost.shape == (1, 41, 8, 16, 20)
    assert cost.is_contiguous()
    same = cost.contiguous()
    assert same.data_ptr() == cost.data_ptr()
    dense = cost[0].permute(1, 2, 3, 0)
    assert dense.permute(3, 0, 1, 2)[None].is_contiguous()


def test_mvsnet_cost_input_is_the_sweep_output(monkeypatch):
    """MVSNet hands the sweep's tensor to CostRegNet's first conv as is."""
    from mvsnerf_tpu_torch.models import mvsnet as m
    seen = {}
    orig = m.CostRegNet.forward

    def spy(self, x):
        seen["ncdhw"] = x.is_contiguous()
        seen["ptr"] = x.data_ptr()
        return orig(self, x)

    real_build = m.build_cost_volume

    def build(*a, **k):
        cost = real_build(*a, **k)
        seen["cost_ptr"] = cost.data_ptr()
        return cost

    monkeypatch.setattr(m.CostRegNet, "forward", spy)
    monkeypatch.setattr(m, "build_cost_volume", build)
    net = m.MVSNet()
    imgs = torch.rand(3, 32, 48, 3, generator=torch.Generator()
                      .manual_seed(1))
    projs = torch.eye(4)[:3].expand(3, 3, 4).contiguous()
    with torch.no_grad():
        vol, _ = net(imgs, projs, torch.tensor([2.0, 5.0]), pad=4,
                     n_planes=8)
    assert vol.shape == (8, 16, 20, 8)
    assert seen["ncdhw"] and seen["ptr"] == seen["cost_ptr"]


def test_sweep_wrapper_rejects_other_devices():
    """Only CPU tensors take the plain twin; a device with no kernel
    raises."""
    from mvsnerf_tpu_torch.ops.sweep import sweep_cost_volume
    srcs = torch.empty(3, 8, 8, 35, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sweep_cost_volume(srcs, torch.empty(3, 3, 4, device="meta"),
                          torch.empty(4, device="meta"), 1, 32)

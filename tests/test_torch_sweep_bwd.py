"""K2's plain twin (the port's gradient of build_cost_volume on the CPU)
against the JAX package's, at the shapes of tests/test_pallas_sweep2.py
(H, W, C, PAD = 24, 40, 8, 4; 3 views), for the loss sum(cost^2 +
0.3 cost).

References: `jax.grad` of JAX `build_cost_volume` on the exact gather
(`fast_warp=False`), and of its Pallas path (the TPU kernel K2 replaces,
`_xb_bwd_kernel` via `warp_fwd_mode="pallas", warp_band=16`) in interpret
mode. Tolerance: abs <= 1e-5 x (1 + max|ref|) on d feats and d imgs, the
forward's own (tests/test_torch_sweep.py): the gradient is 2 cost + 0.3
pushed through the same warps, and the variance channels it starts from
agree only to that after per-view sums taken in another order. The CUDA
kernel is held against this twin on the card by chip_smoke.py (phase 7).
Also: the CUDA route's autograd wiring, and that it raises rather than
run the twin when there is no card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import t

RNG = np.random.default_rng(11)
H, W, C, PAD, V = 24, 40, 8, 4, 3


def _scene(d):
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


def _port_grads(feats, imgs, projs, depths):
    from mvsnerf_tpu_torch.ops.homography import build_cost_volume
    f, im = t(feats).requires_grad_(), t(imgs).requires_grad_()
    cost = build_cost_volume(im, f, t(projs), t(depths), pad=PAD)
    torch.sum(cost ** 2 + 0.3 * cost).backward()
    return f.grad.numpy(), im.grad.numpy()


def _jax_grads(feats, imgs, projs, depths, **kw):
    from mvsnerf_tpu.ops.homography import build_cost_volume

    def loss(f, im):
        cost = build_cost_volume(im, f, jnp.asarray(projs),
                                 jnp.asarray(depths), pad=PAD, **kw)[0]
        return jnp.sum(cost ** 2 + 0.3 * cost)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(feats), jnp.asarray(imgs))]


def _close(ours, refs):
    for o, r, name in zip(ours, refs, ("d_feats", "d_imgs")):
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(o, r, rtol=0,
                                   atol=1e-5 * (1.0 + np.abs(r).max()),
                                   err_msg=name)


def test_sweep_backward_twin_matches_jax_exact_gather():
    scene = _scene(d=8)
    _close(_port_grads(*scene), _jax_grads(*scene, fast_warp=False))


def test_sweep_backward_twin_matches_jax_pallas_interpret():
    """JAX's Pallas sweep backward (K2's TPU kernel), interpret mode."""
    scene = _scene(d=4)
    _close(_port_grads(*scene),
           _jax_grads(*scene, warp_fwd_mode="pallas", warp_band=16))


def test_sweep_bwd_plain_is_the_autograd_of_the_twin():
    from mvsnerf_tpu_torch.ops.sweep import sweep_cost_volume_bwd_plain, \
        sweep_cost_volume_plain
    gen = torch.Generator().manual_seed(2)
    srcs = torch.randn(3, 10, 12, 35, generator=gen)
    projs = t(_scene(2)[2])
    depths = torch.linspace(2.0, 5.0, 6)
    g = torch.randn(1, 41, 6, 14, 16, generator=gen)
    s = srcs.clone().requires_grad_()
    sweep_cost_volume_plain(s, projs, depths, 2, 32).backward(g)
    ours = sweep_cost_volume_bwd_plain(g, srcs, projs, depths, 2, 32)
    assert torch.equal(ours, s.grad)
    # every channel of every view gets a gradient, view 0's included
    assert all(bool(ours[v, ..., c].abs().max() > 0)
               for v in range(3) for c in (0, 31, 32, 34))


@pytest.mark.parametrize("fmt", [torch.contiguous_format,
                                 torch.channels_last_3d],
                         ids=["NCDHW", "channels_last_3d"])
def test_cuda_route_is_a_function_with_k2_backward(monkeypatch, fmt):
    """The card's autograd wiring, with the two launches replaced by the
    plain twin (no card here): the cost volume has a grad_fn whenever
    `srcs` requires grad, a cotangent in the U-Net's layout (NCDHW, as the
    sweep writes it) or in channels_last_3d reaches K2 through
    build_cost_volume's views without a copy, and the gradient is the
    twin's."""
    from mvsnerf_tpu_torch.ops import homography
    from mvsnerf_tpu_torch.ops import sweep as sw
    seen = {}

    def fwd(srcs, proj_mats, depth_values, pad, c_feat):
        with torch.no_grad():
            return sw.sweep_cost_volume_plain(srcs, proj_mats, depth_values,
                                              pad, c_feat)

    def bwd(g, *args):
        seen["ptr"] = g.data_ptr()
        return sw.sweep_cost_volume_bwd_plain(g, *args)

    monkeypatch.setattr(sw, "sweep_cost_volume_kernel", fwd)
    monkeypatch.setattr(sw, "sweep_cost_volume_bwd_kernel", bwd)
    monkeypatch.setattr(homography, "sweep_cost_volume",
                        sw._SweepCostVolume.apply)
    gen = torch.Generator().manual_seed(3)
    feats = torch.randn(3, 8, 12, 32, generator=gen)
    imgs = torch.rand(3, 32, 48, 3, generator=gen)
    projs, depths = t(_scene(2)[2]), torch.linspace(2.0, 5.0, 4)
    f = feats.clone().requires_grad_()
    cost = homography.build_cost_volume(imgs, f, projs, depths, pad=2)
    assert cost.grad_fn is not None
    # MVSNet's view of it for the U-Net, and a cotangent in `fmt`
    unet_in = cost.permute(3, 0, 1, 2)[None]
    assert unet_in.is_contiguous()
    g = torch.randn(unet_in.shape, generator=gen).contiguous(
        memory_format=fmt)
    unet_in.backward(g)
    assert seen["ptr"] == g.data_ptr()
    f_ref = feats.clone().requires_grad_()
    sw.sweep_cost_volume_plain(
        torch.cat([f_ref, torch.stack([
            homography.interpolate_bilinear_resize(im, 8, 12)
            for im in imgs])], -1), projs, depths, 2, 32).backward(g)
    assert torch.equal(f.grad, f_ref.grad)
    with torch.no_grad():
        assert homography.build_cost_volume(imgs, feats, projs, depths,
                                            pad=2).grad_fn is None


@pytest.mark.parametrize("which", ["forward", "backward", "autograd"])
def test_cuda_route_without_a_card_raises(which):
    """The kernel route refuses CPU tensors instead of running the twin."""
    from mvsnerf_tpu_torch.ops import sweep as sw
    srcs = torch.zeros(3, 8, 8, 35)
    args = (torch.eye(4)[:3].expand(3, 3, 4).contiguous(),
            torch.linspace(2.0, 5.0, 4), 1, 32)
    with pytest.raises(ValueError, match="not a CUDA device"):
        if which == "forward":
            sw.sweep_cost_volume_kernel(srcs, *args)
        elif which == "backward":
            sw.sweep_cost_volume_bwd_kernel(torch.zeros(1, 41, 4, 10, 10),
                                            srcs, *args)
        else:
            sw._SweepCostVolume.apply(srcs.requires_grad_(), *args)

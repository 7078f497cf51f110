"""K4's plain twin (per-sample colours + masks from 3 source views)
against the JAX package's `build_color_volume(mode="gather")`, on the CPU,
with samples that fall outside the images (border clamp, mask 0).

Tolerance: abs <= 1e-5, not the starting 1e-6. The twin writes the
projection out element-wise, in the order the CUDA kernel evaluates it, so
that kernel and twin agree bit for bit on the card (chip_smoke.py holds
them to 1e-6). XLA's CPU dot rounds 3-8 % of those projections one ulp
differently (a probe of every summation order found none that matches it
exactly), and one ulp of a 64-px coordinate (~4e-6 px) times a random
image's ~1/px gradient moves a colour by a few 1e-6 (measured max 7e-6).
The masks must agree exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_common import t

RNG = np.random.default_rng(3)
V, H, W = 3, 48, 64


def _views():
    imgs = RNG.uniform(0, 1, (V, H, W, 3)).astype(np.float32)
    intr = np.array([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]],
                    np.float32)
    w2cs = []
    for i in range(V):
        a = 0.06 * (i - 1)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]]
        m[:3, 3] = [0.25 * (i - 1), 0.02 * i, 0.0]
        w2cs.append(m)
    return imgs, np.stack(w2cs), np.stack([intr] * V)


def _points(n, s, spread):
    """World points in front of the cameras; `spread` > 1 sends a share of
    them outside the images."""
    xy = RNG.uniform(-spread, spread, (n, s, 2))
    z = RNG.uniform(2.0, 5.0, (n, s, 1))
    return np.concatenate([xy * z * 0.45, z], -1).astype(np.float32)


@pytest.mark.parametrize("spread", [0.8, 1.6])
def test_color_warp_twin_matches_jax(spread):
    from mvsnerf_tpu.render.renderer import build_color_volume
    from mvsnerf_tpu_torch.ops.color_warp import color_warp
    imgs, w2cs, intrs = _views()
    pts = _points(64, 16, spread)
    ref = np.asarray(build_color_volume(
        jnp.asarray(pts), jnp.asarray(w2cs), jnp.asarray(intrs),
        jnp.asarray(imgs), with_mask=True, mode="gather"))
    out = color_warp(t(pts), t(w2cs), t(intrs), t(imgs)).numpy()
    assert out.shape == ref.shape == (64, 16, 4 * V)
    masks = out[..., 3::4]
    if spread > 1:  # the case exercises border clamping and mask 0
        assert 0.05 < (masks == 0).mean() < 0.95
    np.testing.assert_array_equal(masks, ref[..., 3::4])
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_color_warp_wrapper_rejects_other_devices():
    from mvsnerf_tpu_torch.ops.color_warp import color_warp
    m = torch.empty(2, 8, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        color_warp(m, torch.empty(3, 4, 4, device="meta"),
                   torch.empty(3, 3, 3, device="meta"),
                   torch.empty(3, 8, 8, 3, device="meta"))

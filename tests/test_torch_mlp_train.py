"""K7's plain route (the v0 MLP for training losses, on the CPU) against
the JAX package's `mlp_apply` at HIGHEST precision under `jax.grad`: the
forward, every parameter gradient and the feats-slice input gradient. On
that route the PE and view-direction slices of the input gradient are
exactly zero (the gradient contract of mvsnerf_tpu/ops/pallas_mlp.py:35-40),
and the gradient lands on the module's own parameters. The CUDA kernel is
held against its twin on the card by chip_smoke.py.

Tolerances: forward abs <= 1e-5; gradients abs <= 1e-4 x (1 + max|g|)
(f32 sums over all samples in another order than XLA's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import jax_params, port_modules, t

N, S = 6, 40


def _case(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (N, S, 86)).astype(np.float32)
    g = rng.standard_normal((N, S, 4)).astype(np.float32)
    return x, g


def _jax_ref(mlp_p, x, g):
    from mvsnerf_tpu.models.nerf_mlp import mlp_apply

    def f(p, xx):
        return jnp.sum(mlp_apply(p, xx, "v0", 63, 3) * g)

    out = mlp_apply(mlp_p, jnp.asarray(x), "v0", 63, 3)
    gp, gx = jax.grad(f, argnums=(0, 1))(mlp_p, jnp.asarray(x))
    return np.asarray(out), jax.tree.map(np.asarray, gp), np.asarray(gx)


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=1e-4 * (1 + np.abs(b).max()))


@pytest.mark.parametrize("seed", [0, 1])
def test_mlp_v0_train_matches_jax(seed):
    from mvsnerf_tpu_torch.io.torch_ckpt import state_dicts_from_jax
    from mvsnerf_tpu_torch.ops.mlp_train import mlp_v0_train
    mlp_p, mvs_p = jax_params(seed)
    x, g = _case(seed)
    ref, ref_gp, ref_gx = _jax_ref(mlp_p, x, g)
    mlp, _ = port_modules(mlp_p, mvs_p)
    xs = t(x).requires_grad_()
    out = mlp_v0_train(mlp, xs)
    assert out.shape == (N, S, 4)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-5)

    names, params = zip(*mlp.named_parameters())
    gx, *gp = torch.autograd.grad(out, (xs, *params), t(g))
    ref_sd = state_dicts_from_jax(ref_gp, mvs_p)[0]
    for name, grad in zip(names, gp):
        _close(grad.numpy(), ref_sd[name].numpy())
    _close(gx[..., 63:83].numpy(), ref_gx[..., 63:83])
    assert np.abs(ref_gx[..., :63]).max() > 0  # the true gradient is not 0
    assert torch.count_nonzero(gx[..., :63]) == 0
    assert torch.count_nonzero(gx[..., 83:]) == 0


def test_packed_gradient_lands_on_the_module():
    """backward() through mlp_v0_train fills each nn.Linear's .grad with
    what autograd of the module's own forward gives."""
    from mvsnerf_tpu_torch.ops.mlp_train import mlp_v0_train, \
        mlp_v0_train_plain
    mlp_p, mvs_p = jax_params(2)
    x, g = _case(2)
    mlp, _ = port_modules(mlp_p, mvs_p)
    mlp_v0_train(mlp, t(x)).backward(t(g))
    got = {n: p.grad.clone() for n, p in mlp.named_parameters()}
    mlp.zero_grad()
    mlp_v0_train_plain(mlp, t(x)).backward(t(g))
    for n, p in mlp.named_parameters():
        assert got[n].shape == p.shape
        np.testing.assert_allclose(got[n].numpy(), p.grad.numpy(), rtol=0,
                                   atol=1e-5 * (1 + p.grad.abs().max()))


def test_mlp_v0_bwd_plain_packs_like_the_kernel():
    """The backward twin returns dW in the packed layout the kernel
    writes, `pack_v0_weights`'s: carried back through that packing's own
    VJP, it gives the module's parameter gradients."""
    from mvsnerf_tpu_torch.ops.mlp_train import mlp_v0_bwd_plain
    from mvsnerf_tpu_torch.ops.render_fused import pack_v0_weights
    mlp, _ = port_modules(*jax_params(3))
    x, g = (a.reshape(-1, a.shape[-1]) for a in _case(3))
    dx, dw = mlp_v0_bwd_plain(mlp, t(x), t(g))
    assert dx.shape == x.shape
    params = list(mlp.parameters())
    got = torch.autograd.grad(pack_v0_weights(mlp), params, dw)
    mlp(t(x)).backward(t(g))
    for p, gp in zip(params, got):
        np.testing.assert_allclose(gp.numpy(), p.grad.numpy(), rtol=0,
                                   atol=1e-5 * (1 + p.grad.abs().max()))


def test_mlp_v0_train_rejects_other_devices():
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.ops.mlp_train import mlp_v0_train
    with pytest.raises(ValueError, match="no kernel"):
        mlp_v0_train(MVSNeRF(), torch.empty(8, 86, device="meta"))

"""The port's FeatureNet, CostRegNet and v0 MLP against the JAX package's
feature_net_apply / cost_reg_apply / mlp_v0_apply on the same weights and
inputs, at small sizes on the CPU. Weights go JAX init -> state dicts, and
JAX init -> reference checkpoint on disk -> load_state_dict(strict=True);
both routes must give identical port outputs.

Tolerance: abs <= 1e-4 * (1 + max|ref|) (f32 convolutions and matmuls
summed in different orders by XLA and PyTorch)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_common import (jax_params, port_modules,
                               port_modules_via_checkpoint, t)

RNG = np.random.default_rng(5)


@pytest.fixture(scope="module")
def params():
    return jax_params(0)


def _close(out, ref):
    ref = np.asarray(ref)
    tol = 1e-4 * (1.0 + np.abs(ref).max())
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=tol)


def test_state_dict_keys_match_reference_export(params, tmp_path):
    """Both weight routes load strictly and hold identical tensors."""
    mlp_a, mvs_a = port_modules(*params)
    mlp_b, mvs_b = port_modules_via_checkpoint(*params,
                                               tmp_path / "ck.tar")
    for a, b in ((mlp_a, mlp_b), (mvs_a, mvs_b)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("shape", [(2, 32, 48), (3, 24, 40)])
def test_feature_net_matches_jax(params, shape):
    from mvsnerf_tpu.models.mvsnet import feature_net_apply
    x = RNG.standard_normal((*shape, 3)).astype(np.float32)
    ref = feature_net_apply(params[1]["feature"], jnp.asarray(x))
    _, mvs = port_modules(*params)
    with torch.no_grad():
        out = mvs.feature(t(x))
    assert out.shape == ref.shape
    _close(out, ref)


@pytest.mark.parametrize("dhw", [(8, 16, 16), (12, 20, 28)])
def test_cost_reg_net_matches_jax(params, dhw):
    """(12, 20, 28) is not a multiple of 8: padded and cropped back."""
    from mvsnerf_tpu.models.mvsnet import cost_reg_apply
    x = RNG.standard_normal((1, *dhw, 41)).astype(np.float32)
    ref = cost_reg_apply(params[1]["cost_reg_2"], jnp.asarray(x))
    _, mvs = port_modules(*params)
    xt = t(x).permute(0, 4, 1, 2, 3).contiguous(
        memory_format=torch.channels_last_3d)
    with torch.no_grad():
        out = mvs.cost_reg_2(xt).permute(0, 2, 3, 4, 1)
    assert out.shape == ref.shape
    _close(out, ref)


def test_mlp_v0_matches_jax(params, tmp_path):
    from mvsnerf_tpu.models.nerf_mlp import mlp_v0_apply
    x = np.concatenate([RNG.uniform(-1, 1, (64, 8, 63)),
                        RNG.standard_normal((64, 8, 20)),
                        RNG.standard_normal((64, 8, 3))], -1
                       ).astype(np.float32)
    ref = mlp_v0_apply(params[0], jnp.asarray(x), 63, 3)
    mlp_a, _ = port_modules(*params)
    mlp_b, _ = port_modules_via_checkpoint(*params, tmp_path / "ck.tar")
    with torch.no_grad():
        out_a, out_b = mlp_a(t(x)), mlp_b(t(x))
    assert torch.equal(out_a, out_b)
    _close(out_a, ref)


def test_abn_uses_batch_statistics(params):
    """ABN normalises with the batch's statistics even though the
    running statistics are loaded (the reference runs MVSNet in train
    mode at inference)."""
    from mvsnerf_tpu_torch.models.layers import ABN
    abn = ABN(4)
    abn.running_mean.fill_(100.0)
    abn.running_var.fill_(1e-6)
    abn.eval()
    x = torch.randn(2, 4, 5, 5, generator=torch.Generator().manual_seed(0))
    y = abn(x)
    ref = torch.nn.functional.leaky_relu(
        (x - x.mean((0, 2, 3), keepdim=True))
        / torch.sqrt(x.var((0, 2, 3), unbiased=False, keepdim=True) + 1e-5),
        0.01)
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-5)

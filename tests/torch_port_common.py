"""Shared helpers of the tests/test_torch_*.py parity tests: JAX parameters
made from a seed, converted to the port's modules by both routes (the
in-memory state dicts and a reference-format checkpoint on disk)."""

import numpy as np
import torch

import jax


def jax_params(seed: int = 0):
    """(mlp, mvsnet) parameter pytrees in the JAX package's layout
    (the structure of init_mlp / init_mvsnet, read with jax.eval_shape),
    with numpy leaves drawn from `seed`: kernels uniform in
    +-1/sqrt(fan_in), biases N(0, 0.05), ABN scales U(0.5, 1.5), running
    statistics 0 / 1. (Calling the JAX initialisers themselves compiles
    for tens of seconds on the CPU.)"""
    from mvsnerf_tpu.models import init_mlp, init_mvsnet
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)

    def fill(tree, name=None):
        if isinstance(tree, dict):
            return {k: fill(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [fill(v) for v in tree]
        shape = tuple(tree.shape)
        if name == "kernel":
            b = 1.0 / np.sqrt(np.prod(shape[:-1]))
            a = rng.uniform(-b, b, shape)
        elif name == "bias":
            a = rng.normal(0, 0.05, shape)
        elif name == "scale":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "var":
            a = np.ones(shape)
        else:
            a = np.zeros(shape)
        return a.astype(np.float32)

    mlp = jax.eval_shape(lambda k: init_mlp(k, "v0"), key)
    mvsnet = jax.eval_shape(init_mvsnet, key)
    return fill(mlp), fill(mvsnet)


def port_modules(mlp_params, mvsnet_params):
    """The port's (MVSNeRF, MVSNet) on the CPU, from in-memory state
    dicts."""
    from mvsnerf_tpu_torch.io.torch_ckpt import (modules_from_state_dicts,
                                                 state_dicts_from_jax)
    return modules_from_state_dicts(
        *state_dicts_from_jax(mlp_params, mvsnet_params), device="cpu")


def port_modules_via_checkpoint(mlp_params, mvsnet_params, path):
    """The same modules through export_reference_checkpoint ->
    load_reference_checkpoint(strict=True)."""
    from mvsnerf_tpu.io.torch_ckpt import export_reference_checkpoint
    from mvsnerf_tpu_torch.io.torch_ckpt import load_reference_checkpoint
    export_reference_checkpoint(str(path), mlp_params, mvsnet_params)
    mlp, mvsnet, volume = load_reference_checkpoint(str(path), device="cpu")
    assert volume is None
    return mlp, mvsnet


def t(a):
    return torch.tensor(np.asarray(a, np.float32))

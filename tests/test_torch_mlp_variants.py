"""The v1, v2 and fusion MLPs (and v0 at another shape) against the JAX
package on the CPU, on seeded weights (`jax_mlp_params`: init_mlp's
structure) carried across by `state_dicts_from_jax` into a strict load:

- the forward, the alpha head and the gradients of both in every weight
  against JAX's `mlp_apply`, `mlp_apply_alpha` and `jax.grad`: abs <=
  1e-5 x (1 + max|ref|) (forward, alpha), 1e-5 x max|g| (gradients);
- `render_rays` on the eval route (`grid_sample` fetch) and the training
  route (K5's twin, autograd) against JAX's `render_rays(net_type=...,
  mlp_impl="xla")`, v1's folded feats included: abs <= 1e-5 x
  (1 + max|ref|); K7 and K8 are never called for these MLPs;
- the refusals: tiled and hybrid renders, v1's alpha head, fusion with v1;
- the generalizable step runs with each type, the fusion trainer with its
  own MLP.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import jax_mlp_params, t

# (net_type, D, W): the three MLPs at the reference shape, and v0 / v2 at
# a shape the v0 kernels do not take
SHAPES = [("v1", 6, 128), ("v2", 6, 128), ("fusion", 6, 128),
          ("v0", 4, 64), ("v2", 4, 64)]
IDS = [f"{n}-D{d}-W{w}" for n, d, w in SHAPES]
N_RAYS, N_SAMPLES = 24, 6
V, H, W_IMG, D_VOL = 3, 16, 16, 8


def _port_mlp(net_type, D, W, params):
    from mvsnerf_tpu_torch.io.torch_ckpt import state_dicts_from_jax
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    fn_sd, mvs_sd = state_dicts_from_jax(params, None, net_type)
    assert mvs_sd is None
    mlp = MVSNeRF(net_type, D, W)
    mlp.load_state_dict(fn_sd, strict=True)
    return mlp


def _mlp_input(seed, n=N_RAYS, s=N_SAMPLES):
    """(n, s, 86) = [PE-like (63) | volume (8) | 3 x (RGB, mask) | dirs];
    a third of the masks are 0."""
    rng = np.random.default_rng(seed)
    views = [np.concatenate([rng.uniform(0, 1, (n, s, 3)),
                             rng.uniform(0, 1, (n, s, 1)) > 0.3], -1)
             for _ in range(3)]
    return np.concatenate(
        [rng.uniform(-1, 1, (n, s, 63)), rng.normal(0, 1, (n, s, 8)),
         *views, rng.normal(0, 1, (n, s, 3))], -1).astype(np.float32)


def _close(out, ref, scale=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=scale * (1.0 + np.abs(ref).max()))


@pytest.mark.parametrize("net_type", ["v1", "v2", "fusion"])
def test_state_dict_round_trips_through_jax_reader(net_type):
    """state_dicts_from_jax -> strict load -> the module's state dict ->
    JAX's `convert_mlp_state` gives back the same pytree."""
    from mvsnerf_tpu.io.torch_ckpt import convert_mlp_state
    params = jax_mlp_params(net_type, 1)
    mlp = _port_mlp(net_type, 6, 128, params)
    back = convert_mlp_state({k: v.numpy() for k, v in
                              mlp.state_dict().items()}, net_type)
    a, tree_a = jax.tree.flatten(params)
    b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, np.asarray(y))


@pytest.mark.parametrize("net_type,D,W", SHAPES, ids=IDS)
def test_forward_alpha_and_gradients_match_jax(net_type, D, W):
    from mvsnerf_tpu.models.nerf_mlp import mlp_apply, mlp_apply_alpha
    params = jax_mlp_params(net_type, 2, D, W)
    mlp = _port_mlp(net_type, D, W, params)
    x = _mlp_input(3)
    jp = jax.tree.map(jnp.asarray, params)
    ref = jax.jit(lambda p: mlp_apply(p, jnp.asarray(x), net_type, 63,
                                      3))(jp)
    out = mlp(t(x))
    assert out.shape == ref.shape == (N_RAYS, N_SAMPLES,
                                      10 if net_type == "v1" else 4)
    _close(out, ref)
    g = np.random.default_rng(4).normal(0, 1, ref.shape).astype(np.float32)
    heads = [(lambda p: jnp.sum(mlp_apply(p, jnp.asarray(x), net_type, 63, 3)
                                * g), lambda: (mlp(t(x)) * t(g)).sum())]
    if net_type == "v1":
        with pytest.raises(NotImplementedError, match="no alpha head"):
            mlp.forward_alpha(t(x[..., :83]))
    else:
        ref_a = jax.jit(lambda p: mlp_apply_alpha(
            p, jnp.asarray(x[..., :83]), net_type, 63))(jp)
        _close(mlp.forward_alpha(t(x[..., :83])), ref_a)
        heads.append((lambda p: jnp.sum(mlp_apply_alpha(
            p, jnp.asarray(x[..., :83]), net_type, 63) * g[..., :1]),
            lambda: (mlp.forward_alpha(t(x[..., :83])) *
                     t(g[..., :1])).sum()))
    from mvsnerf_tpu_torch.io.torch_ckpt import state_dicts_from_jax
    for jax_loss, port_loss in heads:
        grads = jax.jit(jax.grad(jax_loss))(jp)
        ref_sd = state_dicts_from_jax(jax.tree.map(np.asarray, grads), None,
                                      net_type)[0]
        mlp.zero_grad(set_to_none=True)
        port_loss().backward()
        named = dict(mlp.named_parameters())
        assert named.keys() == ref_sd.keys()
        g_max = max(float(v.abs().max()) for v in ref_sd.values())
        assert g_max > 0
        for name, ref_g in ref_sd.items():
            ours = named[name].grad
            ours = torch.zeros_like(ref_g) if ours is None else ours
            np.testing.assert_allclose(ours.numpy(), ref_g.numpy(), rtol=0,
                                       atol=1e-5 * g_max, err_msg=name)


def _scene(seed=11):
    """A random volume, samples in front of 3 cameras on an arc, their
    NDC in [0, 1], and the views' images."""
    rng = np.random.default_rng(seed)
    intr = np.array([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], np.float32)
    w2cs = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    for i in range(V):
        w2cs[i, 0, 3] = 0.1 * (i - 1)
    z = np.sort(rng.uniform(2, 6, (N_RAYS, N_SAMPLES)), -1)
    dirs = np.concatenate([rng.uniform(-0.3, 0.3, (N_RAYS, 2)),
                           np.ones((N_RAYS, 1))], -1)
    return dict(
        volume=rng.standard_normal((D_VOL, 12, 12, 8)),
        pts_world=dirs[:, None] * z[..., None],
        pts_ndc=rng.uniform(0, 1, (N_RAYS, N_SAMPLES, 3)), z_vals=z,
        rays_dir=dirs, w2c=np.eye(4), w2cs=w2cs, intrinsics=np.stack(
            [intr] * V), imgs=rng.uniform(0, 1, (V, H, W_IMG, 3)))


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("net_type,D,W", SHAPES, ids=IDS)
def test_render_rays_matches_jax(net_type, D, W, training, monkeypatch):
    """The eval route (no gradient: `grid_sample` fetch) and the training
    route (K5's twin) run the module's MLP and `raw2outputs`, never K7 or
    K8, and match JAX's exact route; v1's feats carry its fused colours."""
    from mvsnerf_tpu.render.renderer import render_rays as jax_render
    from mvsnerf_tpu_torch.render import renderer

    def never(*_):
        raise AssertionError("a v0 kernel was called")

    monkeypatch.setattr(renderer, "render_v0_feats", never)
    monkeypatch.setattr(renderer, "render_v0_feats_plain", never)
    monkeypatch.setattr(renderer, "mlp_v0_train", never)
    monkeypatch.setattr(renderer, "mlp_v0_train_plain", never)
    params = jax_mlp_params(net_type, 5, D, W)
    # a density bias that makes the seeded MLPs' renders non-empty
    params["alpha_linear"]["bias"][:] = 0.5
    mlp = _port_mlp(net_type, D, W, params)
    sc = _scene()
    ref = jax.jit(lambda p, *a: jax_render(
        p, *a, w2c_ref=jnp.asarray(sc["w2c"], jnp.float32),
        w2cs=jnp.asarray(sc["w2cs"]), intrinsics=jnp.asarray(
            sc["intrinsics"]), imgs=jnp.asarray(sc["imgs"], jnp.float32),
        net_type=net_type, mlp_impl="xla"))(
        jax.tree.map(jnp.asarray, params),
        *(jnp.asarray(sc[k], jnp.float32) for k in
          ("volume", "pts_world", "pts_ndc", "z_vals", "rays_dir")))
    args = [t(sc[k]) for k in ("volume", "pts_world", "pts_ndc", "z_vals",
                               "rays_dir", "w2c", "w2cs", "intrinsics",
                               "imgs")]
    with torch.set_grad_enabled(training):
        out = renderer.render_rays(mlp, *args, training=training,
                                   twins=True)
    assert out["feats"].shape[-1] == (14 if net_type == "v1" else 20)
    for key in ("rgb", "depth", "acc", "weights", "alpha", "feats"):
        _close(out[key], ref[key])
    assert float(np.asarray(ref["acc"]).min()) > 0.1
    if training:
        out["rgb"].sum().backward()
        assert all(p.grad is not None for p in mlp.parameters())


@pytest.mark.parametrize("mode", ["tiled", "hybrid"])
def test_tiled_and_hybrid_refuse_other_mlps(mode):
    """K6 and K6b compute the v0 MLP alone (JAX's tiled renderer rejects
    the others too, tiled.py:112-113): a v2 MLP, which has v0's shapes,
    raises instead of rendering as v0."""
    from mvsnerf_tpu_torch.eval.evaluate import RENDER_MODES
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.ops.render_fused import pack_v0_weights
    sc = _scene()
    volume = t(sc["volume"])
    pose = {"w2cs": t(sc["w2cs"]), "intrinsics": t(sc["intrinsics"])}
    for mlp in (MVSNeRF("v2"), MVSNeRF("v0", 4, 64)):
        with pytest.raises(ValueError, match="v0 MLP at D=6, W=128"):
            RENDER_MODES[mode](mlp, volume, t(sc["imgs"]),
                               torch.tensor([2.0, 6.0]), pose, 8, 2)
        with pytest.raises(ValueError, match="v0 MLP at D=6, W=128"):
            pack_v0_weights(mlp)


def test_v1_has_no_density_and_fusion_refuses_it():
    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.render.renderer import render_density
    from mvsnerf_tpu_torch.train.fusion import FusionFinetuneSystem
    with pytest.raises(NotImplementedError, match="no alpha head"):
        render_density(MVSNeRF("v1"), torch.zeros(4, 3), torch.zeros(4, 20))
    with pytest.raises(NotImplementedError, match="v1"):
        FusionFinetuneSystem(config_parser("--net_type v1"), None,
                             device="cpu")
    with pytest.raises(ValueError, match="--net_type"):
        MVSNeRF("v3")


@pytest.mark.parametrize("net_type", ["v1", "v2", "fusion"])
def test_generalizable_step_takes_each_type(net_type, monkeypatch):
    """One generalizable step per type on a toy batch: finite, every
    parameter of the MLP trained, K7 never called."""
    from torch_parallel_ranks import generalizable_sample
    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.render import renderer
    from mvsnerf_tpu_torch.train.generalizable import GeneralizableSystem
    monkeypatch.setattr(renderer, "mlp_v0_train", None)
    system = GeneralizableSystem(config_parser(
        f"--dataset_name dtu --pad 4 --N_samples 8 --batch_size 64 "
        f"--with_depth_loss --net_type {net_type}"), device="cpu")
    assert system.mlp.net_type == net_type
    batch = system.batch(generalizable_sample())
    gen = torch.Generator().manual_seed(0)
    loss, aux = system._step(batch, *system.draw(batch, gen))
    assert np.isfinite(float(loss)) and "depth_loss" in aux
    assert all(p.grad is not None for p in system.mlp.parameters())


@pytest.mark.parametrize("net_type", ["fusion"])
def test_fusion_trainer_takes_each_type(net_type, monkeypatch):
    """The fusion trainer with another MLP than v0 (its own, whose colour
    attention reads the fused volume's per-view colours): the fuse forms
    alpha on the module's route (K8 is never called), and a step trains
    it."""
    from test_torch_fusion import PAD, Scene
    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.render import renderer
    from mvsnerf_tpu_torch.train.fusion import FusionFinetuneSystem
    monkeypatch.setattr(FusionFinetuneSystem, "VOLUME_DIM", (8, 8, 8))
    monkeypatch.setattr(renderer, "render_v0_feats", None)
    monkeypatch.setattr(renderer, "mlp_v0_train", None)
    scene = Scene()
    system = FusionFinetuneSystem(config_parser(
        f"--pad {PAD} --N_samples 8 --batch_size 64 --perturb 0 "
        f"--net_type {net_type}"), scene, device="cpu")
    assert system.mlp.net_type == net_type
    assert tuple(system.volume.shape) == (8, 8, 8, 20)
    assert torch.isfinite(system.volume).all()
    assert float(system.fuse_acc[..., 21].max()) > 0  # trilinear weights
    loss = system._step(t(scene.all_rays[:64]), t(scene.all_rgbs[:64]))
    assert np.isfinite(float(loss))
    assert all(p.grad is not None for p in system.mlp.parameters())

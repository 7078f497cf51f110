"""The port's density volume, importance sampling and `--use_disp` in the
fine-tune trainer against the JAX package, on the CPU, on
test_torch_finetune.py's tiny scene and weights (5 views of 32x32, pad 4,
128 planes, 16 samples plus 8 importance samples, batches of 256 rays,
perturb 0).

JAX draws its uniforms from PRNG keys and the port from torch.Generators,
so the port is fed JAX's own draws through the `u=` keyword of
`sample_pdf` / `ray_marcher_fine`. Tolerances: depths and points abs <=
1e-5 x max|z|; densities abs <= 1e-5 x (1 + max|sigma|); steps as in
test_torch_finetune.py (loss rel <= 1e-5, gradients abs <= 1e-4 x
max|g|, parameters after 3 steps abs <= 1e-5), held against JAX autodiff
of the exact gather (`render_rays(fast_volume_grad=False,
mlp_impl="xla")`): JAX's own `FinetuneSystem._step` resolves to the banded
VJP off the TPU, which drops taps exactly when N_importance > 0; renders
as in test_torch_tiled.py (rgb, acc abs <= 1e-5, depth <= 5e-5). Also
here: the 200-step refresh and the validation offset of `fit`, the tiled
renderer's cache across a refresh, and the fine-tune CLI with all three
flags, trained and resumed.
"""

import contextlib
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_finetune import H, KINK, N_SAMPLES, PAD, W, Scene, \
    _port_args, case  # noqa: F401  (`case` is a fixture)
from torch_port_common import jax_params, port_modules, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IMP = 8
DENSITY = f"--use_density_volume --N_importance {N_IMP}"
# the importance draws of the JAX steps: the key JAX's trainer folds in
KEY_FINE = jax.random.fold_in(jax.random.PRNGKey(0), 1)
# rays a step keeps, each clear of every ReLU kink at all its samples
KEPT = 96
# the importance depths of a step's rays: JAX's float32 route and the
# port's put them up to ~4e-5 apart (JAX's farther from a float64 run than
# the port's): the inverse CDF divides the CDF's rounding by a bin's
# probability. The PE then multiplies the NDC's difference by up to 2**9,
# and 5e-6 moves a voxel's gradient by more than the steps' tolerance.
# Rays whose depths the two put more than Z_AGREE (~4 float32 steps at
# z = 4) apart are left out of the density steps, which keep KEPT_FINE rays
# of batches of BATCH_FINE (ray_marcher_fine is held to 1e-5 x max|z| on
# all its rays above).
Z_AGREE, KEPT_FINE, BATCH_FINE = 2e-6, 64, 1024


def _close(ours, ref, scale, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=0,
                               atol=scale, err_msg=what)


@contextlib.contextmanager
def _uniforms(u):
    """The port's importance draws are `u` (the `u=` seam of
    `ray_marcher_fine`) inside the block."""
    from mvsnerf_tpu_torch.ops.sampling import ray_marcher_fine
    from mvsnerf_tpu_torch.render import renderer
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(renderer, "ray_marcher_fine",
                   functools.partial(ray_marcher_fine, u=t(u)))
        yield


def _system(case, ckpt=None, extra=""):
    from mvsnerf_tpu_torch.train.finetune import FinetuneSystem
    return FinetuneSystem(_port_args(ckpt or case["ckpt"], extra),
                          case["scene"], device="cpu")


# sample_pdf's empty bins: an empty bin's CDF step is 1e-5 / (sum of the
# weights + 1e-5 a bin), within float32 rounding of the 1e-5 at which the
# reference takes its `denom < 1e-5` branch when the ray's weights sum to
# about 1 (an opaque ray). A draw in such a bin may take either branch on
# either side and move by up to the bin's width: those draws' rays are left
# out. The margin is a few float32 steps of the CDF's summands.
AMBIGUOUS = 1e-6


def _ambiguous_rays(density, z, ndc, u):
    """(N,) bool: rays with an importance draw `u` in a bin whose CDF step
    (float64) lies within AMBIGUOUS of 1e-5, as `ray_marcher_fine` draws
    them from `density` at coarse depths `z` and their `ndc`."""
    from mvsnerf_tpu_torch.ops.compositing import raw2alpha
    from mvsnerf_tpu_torch.ops.interp import grid_sample_3d
    sigma = grid_sample_3d(t(density).double(),
                           t(ndc).double() * 2.0 - 1.0)[..., 0]
    w = raw2alpha(torch.relu(sigma))[1][:, 1:-1] + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    u = t(u).double().contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    denom = cdf.gather(-1, inds.clamp(max=cdf.shape[-1] - 1)) - \
        cdf.gather(-1, (inds - 1).clamp(min=0))
    return ((denom - 1e-5).abs() < AMBIGUOUS).any(-1).numpy()


# ------------------------------------------------------------ sampling ---

def _pdf_case(zeros):
    rng = np.random.default_rng(3)
    bins = np.sort(rng.uniform(2.0, 6.0, (64, 17)), -1).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, (64, 16)).astype(np.float32)
    if zeros:  # empty bins: denom < 1e-5 beside heavy ones
        weights[:, ::2] = 0.0
        weights[:8] = 0.0
        weights[8:16, 3] = 50.0
    return bins, weights


@pytest.mark.parametrize("det,zeros", [(False, False), (True, False),
                                       (False, True), (True, True)])
def test_sample_pdf_matches_jax(det, zeros):
    from mvsnerf_tpu.ops.sampling import sample_pdf as jax_pdf
    from mvsnerf_tpu_torch.ops.sampling import sample_pdf
    bins, weights = _pdf_case(zeros)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jax_pdf(key, jnp.asarray(bins), jnp.asarray(weights),
                             24, det=det))
    u = None if det else np.asarray(jax.random.uniform(key, (64, 24)))
    ours = sample_pdf(t(bins), t(weights), 24, det=det,
                      u=None if u is None else t(u))
    _close(ours, ref, 1e-5 * np.abs(ref).max())
    if not det:  # the generator's draws: seeded, inside the bins
        a, b = (sample_pdf(t(bins), t(weights), 24,
                           generator=torch.Generator().manual_seed(7))
                for _ in range(2))
        assert torch.equal(a, b) and not torch.allclose(a, ours)
        assert bool((a >= t(bins)[:, :1]).all() and
                    (a <= t(bins)[:, -1:]).all())


@pytest.mark.parametrize("lindisp", [False, True])
def test_dda_and_bbox_ray_marcher_match_jax(lindisp):
    from mvsnerf_tpu.ops import sampling as js
    from mvsnerf_tpu_torch.ops import sampling as ps
    rng = np.random.default_rng(11)
    o = rng.uniform(-0.2, 0.2, (50, 3)).astype(np.float32)
    d = rng.standard_normal((50, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d[:5, 0] = 0.0  # axis-parallel rays: the 1e-6 guard
    rays = np.concatenate([o, d, np.full((50, 2), [2.0, 6.0])], -1).astype(
        np.float32)
    bbox = np.array([[-1.0, -0.8, 2.5], [1.2, 0.9, 5.0]], np.float32)
    ref = js.dda(jnp.asarray(o), jnp.asarray(d), jnp.asarray(bbox))
    ours = ps.dda(t(o), t(d), t(bbox))
    for a, b in zip(ours, ref):
        _close(a, b, 1e-5 * np.abs(np.asarray(b)).max())
    xyz_r, _, _, z_r = js.ray_marcher(jax.random.PRNGKey(0),
                                      jnp.asarray(rays), 16, lindisp=lindisp,
                                      bbox_3d=jnp.asarray(bbox))
    xyz, _, _, z = ps.ray_marcher(t(rays), 16, lindisp=lindisp,
                                  bbox_3d=t(bbox))
    _close(z, z_r, 1e-5 * np.abs(np.asarray(z_r)).max())
    _close(xyz, xyz_r, 1e-5 * np.abs(np.asarray(z_r)).max())
    # the box's entry and exit, not the rays' own near and far
    _close(z[:, 0], ours[0][:, 0], 1e-5 * np.abs(np.asarray(z_r)).max())
    assert float((z[:, 0] - 2.0).abs().mean()) > 0.1


def test_ray_marcher_fine_matches_jax():
    from mvsnerf_tpu.ops import sampling as js
    from mvsnerf_tpu_torch.ops import sampling as ps
    scene = Scene()
    rays = scene.all_rays[::4][:200]
    rng = np.random.default_rng(12)
    density = (rng.standard_normal((32, 16, 16, 1)) * 2.0).astype(np.float32)
    z = np.asarray(js.ray_marcher(jax.random.PRNGKey(0), jnp.asarray(rays),
                                  N_SAMPLES)[3])
    ndc = rng.uniform(-0.05, 1.05, (200, N_SAMPLES, 3)).astype(np.float32)
    ref = js.ray_marcher_fine(KEY_FINE, jnp.asarray(rays),
                              jnp.asarray(density), jnp.asarray(z),
                              jnp.asarray(ndc), N_IMP)
    u = np.asarray(jax.random.uniform(KEY_FINE, (200, N_IMP)))
    dens = t(density).requires_grad_()
    ours = ps.ray_marcher_fine(t(rays), dens, t(z), t(ndc), N_IMP, u=t(u))
    scale = 1e-5 * np.abs(z).max()
    ok = ~_ambiguous_rays(density, z, ndc, u)
    assert ok.mean() > 0.9
    _close(ours[3][ok], np.asarray(ref[3])[ok], scale, "z_vals")
    _close(ours[0][ok], np.asarray(ref[0])[ok], scale, "xyz")
    assert ours[3].shape == (200, N_SAMPLES + N_IMP)
    assert bool((ours[3].diff(dim=-1) >= 0).all())
    # the draws are detached: nothing reaches the density volume
    assert not ours[3].requires_grad
    # they moved the depths: not only the coarse ones again
    assert np.abs(np.asarray(ref[3])[:, ::2][:, :N_SAMPLES // 2]
                  - z[:, :N_SAMPLES // 2]).max() > 1e-3


def test_forward_alpha_and_render_density_match_jax():
    from mvsnerf_tpu.render.renderer import render_density as jax_density
    from mvsnerf_tpu_torch.render.renderer import render_density
    rng = np.random.default_rng(13)
    mlp_p = jax_params(0)[0]
    mlp, _ = port_modules(*jax_params(0))
    pts = rng.uniform(-0.1, 1.1, (1000, 3)).astype(np.float32)
    feats = rng.standard_normal((1000, 20)).astype(np.float32)
    ref = np.asarray(jax_density(mlp_p, jnp.asarray(pts),
                                 jnp.asarray(feats)))
    ours = render_density(mlp, t(pts), t(feats), chunk=256)
    assert ours.shape == (1000, 1) and 0.05 < (ref > 0).mean() < 0.95
    _close(ours, ref, 1e-5 * (1 + np.abs(ref).max()))
    # the alpha head of the full forward, whatever the view direction
    from mvsnerf_tpu_torch.ops.encoding import positional_encoding
    x = torch.cat([positional_encoding(t(pts), 10), t(feats)], -1)
    full = mlp(torch.cat([x, torch.randn(1000, 3)], -1))[:, 3:]
    with torch.no_grad():
        assert torch.equal(mlp.forward_alpha(x), full)


# ------------------------------------------------------- density volume --

def _jax_bake(case, volume):
    """JAX's voxel centres and colours (with masks), as its `_init_volume`
    computes them."""
    from mvsnerf_tpu.render.renderer import build_color_volume
    from mvsnerf_tpu.train.common import unpreprocess_images
    from mvsnerf_tpu.train.finetune import frustum_point_volume
    imgs_norm, _, nf, pose = case["scene"].read_source_views()
    d, hp, wp = volume.shape[:3]
    intr_s4 = jnp.asarray(pose["intrinsics"][0]) / \
        jnp.asarray([[4.0], [4.0], [1.0]])
    vox = frustum_point_volume(hp - 2 * PAD, wp - 2 * PAD, d, PAD,
                               jnp.asarray(nf, jnp.float32), intr_s4,
                               jnp.asarray(pose["c2ws"][0]))
    color = build_color_volume(
        vox.reshape(d, -1, 3), jnp.asarray(pose["w2cs"]),
        jnp.asarray(pose["intrinsics"]),
        unpreprocess_images(jnp.asarray(imgs_norm)),
        with_mask=True).reshape(d, hp, wp, -1)
    return {"vox": np.asarray(vox), "color": np.asarray(color)}


@pytest.fixture(scope="module")
def baked(case):
    return _jax_bake(case, case["volume"])


@pytest.mark.parametrize("color_volume", [False, True])
def test_update_density_volume_matches_jax(case, baked, color_volume):
    extra = DENSITY + (" --use_color_volume" if color_volume else "")
    system = _system(case, extra=extra)
    assert system.density_volume is None  # until the first refresh
    system.update_density_volume()
    dv = system.density_volume.numpy()
    # the points and colours against JAX's; a voxel on a view's border may
    # flip its mask by an ulp (as in test_torch_finetune_color.py)
    vox, color = system.vox_pts.numpy(), system.color_feature.numpy()
    _close(vox, baked["vox"], 1e-5 * np.abs(baked["vox"]).max())
    assert (np.abs(color - baked["color"]) > 1e-5).mean() < 1e-3
    # the density against JAX's `render_density` on the same points and
    # features: the PE of WORLD points (the reference's quirk) turns their
    # float32 differences into phase differences of up to 2**9 x theirs
    from mvsnerf_tpu.render.renderer import render_density
    feats = system.volume.detach().numpy()
    if not color_volume:
        feats = np.concatenate([feats, color], -1)
    else:  # the features are the trained 20-channel volume
        assert feats.shape[-1] == 20
    ref = np.asarray(render_density(
        case["mlp"], jnp.asarray(vox.reshape(-1, 3)),
        jnp.asarray(feats.reshape(vox[..., 0].size, -1)))).reshape(dv.shape)
    assert dv.shape == (128, 16, 16, 1) and 0.05 < (ref > 0).mean() < 0.95
    _close(dv, ref, 1e-5 * (1 + np.abs(ref).max()))


# --------------------------------------------------------------- steps ---

def _jax_stepper(case, volume, density=None, lindisp=False):
    """The JAX reference step (jitted; exact gather, autodiff) with the
    importance step of JAX finetune.py:166-175 when `density` is given,
    its initial state, and its samples' depths as a function of the
    rays."""
    from mvsnerf_tpu.ops.geometry import get_ndc_coordinate
    from mvsnerf_tpu.ops.sampling import ray_marcher, ray_marcher_fine
    from mvsnerf_tpu.render.renderer import render_rays
    from mvsnerf_tpu.train.common import unpreprocess_images
    from mvsnerf_tpu.utils.schedulers import make_lr_schedule
    imgs_norm, _, nf, pose = case["scene"].read_source_views()
    imgs = unpreprocess_images(jnp.asarray(imgs_norm))
    w2cs, intrs = jnp.asarray(pose["w2cs"]), jnp.asarray(pose["intrinsics"])
    near_far = jnp.asarray(nf, jnp.float32)

    def ndc(p):
        return get_ndc_coordinate(w2cs[0], intrs[0], p,
                                  jnp.asarray([W - 1.0, H - 1.0]),
                                  near=near_far[0], far=near_far[1],
                                  pad=PAD, lindisp=lindisp)

    def samples(rays):
        pts, _, rays_d, z = ray_marcher(jax.random.PRNGKey(0), rays,
                                        N_SAMPLES, perturb=0.0,
                                        lindisp=lindisp)
        pts_ndc = ndc(pts)
        if density is not None:
            pts, _, rays_d, z = ray_marcher_fine(
                KEY_FINE, rays, jnp.asarray(density), z, pts_ndc, N_IMP)
            pts_ndc = ndc(pts)
        return pts, pts_ndc, z, rays_d

    def loss_fn(params, rays, rgbs):
        pts, pts_ndc, z, rays_d = samples(rays)
        out = render_rays(params["mlp"], params["volume"], pts, pts_ndc, z,
                          rays_d, w2c_ref=w2cs[0], w2cs=w2cs,
                          intrinsics=intrs, imgs=imgs,
                          fast_volume_grad=False, mlp_impl="xla")
        return jnp.mean((out["rgb"] - rgbs) ** 2)

    opt = optax.adam(make_lr_schedule(5e-4, "steplr", (5000, 8000, 9000),
                                      0.5, num_steps=80000), b1=0.9,
                     b2=0.999)

    @jax.jit
    def step(params, opt_state, rays, rgbs):
        loss, grads = jax.value_and_grad(loss_fn)(params, rays, rgbs)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    params = {"mlp": case["mlp"], "volume": jnp.asarray(volume),
              "mvsnet": case["mvs"]}
    depths = jax.jit(lambda rays: samples(rays)[2])
    return step, params, opt.init(params), \
        lambda rays: np.asarray(depths(jnp.asarray(rays)))


def _kink_clear(port, ray, u):
    """Whether every sample of one ray, its importance samples drawn with
    `u` (1, N_IMP), lies more than KINK from every ReLU kink of the MLP at
    the port's state (float64, `relu_margin`; test_torch_finetune.py's
    rule) and draws in no ambiguous empty bin (`_ambiguous_rays`)."""
    from mvsnerf_tpu_torch.ops.mlp_train import relu_margin
    from mvsnerf_tpu_torch.render.renderer import sample_rays
    pose = port.pose_source
    _, _, z, ndc = sample_rays(t(ray), N_SAMPLES, pose["w2cs"][0],
                               pose["intrinsics"][0], (H, W), port.near_far,
                               PAD)
    with _uniforms(u):
        x = port.mlp_input(t(ray))
    return float(relu_margin(port.mlp, x).min()) > KINK and \
        not _ambiguous_rays(port.density_volume, z, ndc, u)[0]


def _kept_rays(port, jax_depths, rays, u, n):
    """`n` rays of `rays` for a step whose i-th ray draws its importance
    samples with u[i]: each clear of the kinks (`_kink_clear`), and each
    with importance depths that JAX's float32 route and the port's put
    within Z_AGREE of each other. A slot whose ray fails takes the next
    unused ray that passes, so the other slots keep their draws."""
    unused = iter(range(len(rays)))

    def clear(i):
        for r in unused:
            if _kink_clear(port, rays[r:r + 1], u[i:i + 1]):
                return r
        raise AssertionError("too few rays clear of the kinks")

    slots = [clear(i) for i in range(n)]
    while True:  # until no slot disagrees, or no ray is left (clear raises)
        with _uniforms(u):
            z = port._samples(t(rays[slots]), None)[2].numpy()
        far = np.flatnonzero(np.abs(z - jax_depths(rays[slots])).max(-1) >
                             Z_AGREE)
        if not len(far):
            return np.array(slots)
        for i in far:
            slots[i] = clear(i)


def _step_runs(case, port, stepper, batches, u=None, kept=KEPT):
    """Steps of the port and of JAX on the same batches, each cut to KEPT
    rays clear of the kinks; the first step's gradients, the first nonzero
    volume gradient of each value and the final parameters."""
    from mvsnerf_tpu_torch.io.torch_ckpt import state_dicts_from_jax
    from mvsnerf_tpu_torch.ops.mlp_train import relu_margin
    step, params, opt_state = stepper[:3]
    out = {"port_loss": [], "jax_loss": []}
    for b in batches:
        if u is None:
            margin = relu_margin(port.mlp, port.mlp_input(
                t(b["rays"]))).reshape(len(b["rays"]), -1)
            keep = np.flatnonzero((margin.amin(1) > KINK).numpy())[:kept]
            assert len(keep) == kept
        else:
            keep = _kept_rays(port, stepper[3], b["rays"], u, kept)
        batch = {k: v[keep] for k, v in b.items()}
        params, opt_state, loss, grads = step(
            params, opt_state, jnp.asarray(batch["rays"]),
            jnp.asarray(batch["rgbs"]))
        out["jax_loss"].append(float(loss))
        with contextlib.ExitStack() as stack:
            if u is not None:
                stack.enter_context(_uniforms(u))
            out["port_loss"].append(float(port._step(t(batch["rays"]),
                                                     t(batch["rgbs"]))))
        g = {"volume": np.abs(np.asarray(grads["volume"])), **{
            n: v.abs().numpy() for n, v in
            state_dicts_from_jax(grads["mlp"], case["mvs"])[0].items()}}
        first = out.setdefault("gfirst", {n: np.zeros_like(v)
                                          for n, v in g.items()})
        for n, v in g.items():
            first[n] = np.where(first[n] == 0, v, first[n])
        if "jax_grads" not in out:
            out["jax_grads"] = jax.tree.map(np.asarray, grads)
            out["port_grads"] = {
                "volume": port.volume.grad.clone(),
                **{n: p.grad.clone() for n, p in port.mlp.named_parameters()}}
    out["jax_params"] = jax.tree.map(np.asarray, params)
    out["port"] = port
    return out


def _check_first_step(case, runs):
    from mvsnerf_tpu_torch.io.torch_ckpt import state_dicts_from_jax
    loss, ref = runs["port_loss"][0], runs["jax_loss"][0]
    assert abs(loss - ref) <= 1e-5 * abs(ref)
    gv = runs["jax_grads"]["volume"]
    assert np.abs(gv).max() > 0
    _close(runs["port_grads"]["volume"], gv, 1e-4 * np.abs(gv).max())
    ref_sd = state_dicts_from_jax(runs["jax_grads"]["mlp"], case["mvs"])[0]
    for name, g in ref_sd.items():
        _close(runs["port_grads"][name], g, 1e-4 * g.abs().max().item(),
               name)


@pytest.fixture(scope="module")
def density_runs(case):
    """3 density-volume steps of the port and of JAX on the port's density
    volume (held to JAX's above; its world-point PE makes a volume of each
    side differ by more than the steps' tolerances), the port fed JAX's
    importance draws."""
    from mvsnerf_tpu.train.common import RayBatchIterator
    port = _system(case, extra=DENSITY)
    port.update_density_volume()
    stepper = _jax_stepper(case, case["volume"],
                           density=port.density_volume.numpy())
    u = np.asarray(jax.random.uniform(KEY_FINE, (KEPT_FINE, N_IMP)))
    scene = case["scene"]
    it = RayBatchIterator({"rays": scene.all_rays, "rgbs": scene.all_rgbs},
                          BATCH_FINE, seed=0)
    return _step_runs(case, port, stepper, [next(it) for _ in range(3)], u,
                      KEPT_FINE)


def test_density_one_step_matches_jax(case, density_runs):
    _check_first_step(case, density_runs)


def test_density_three_steps_match_jax(case, density_runs):
    from mvsnerf_tpu_torch.io.torch_ckpt import state_dicts_from_jax
    runs = density_runs
    for loss, ref in zip(runs["port_loss"], runs["jax_loss"]):
        assert abs(loss - ref) <= 1e-5 * abs(ref)
    assert len(set(runs["jax_loss"])) == 3
    system, params = runs["port"], runs["jax_params"]
    # Adam's first update of a value whose first gradient is eps-sized is
    # up to lr apart (test_torch_finetune.py; ROADMAP.md, "ReLU kinks and
    # Adam's eps"): those values are held to Adam's bound of lr a step, the
    # MLP's as the volume's (chip_smoke.py's `step_parity` rule)
    ref = {"volume": params["volume"],
           **state_dicts_from_jax(params["mlp"], case["mvs"])[0]}
    ours = {"volume": system.volume,
            **dict(system.mlp.named_parameters())}
    for name, p in ours.items():
        p, r = p.detach().numpy(), np.asarray(ref[name])
        firm = runs["gfirst"][name] > 1e-7
        _close(p[firm], r[firm], 1e-5, name)
        _close(p, r, 3 * 5e-4, name)
    vol = system.volume.detach().numpy()
    gfirst = runs["gfirst"]["volume"]
    firm, untouched = gfirst > 1e-7, gfirst == 0
    assert firm.mean() > 0.1 and (firm | untouched).mean() > 0.9
    np.testing.assert_array_equal(vol[untouched], case["volume"][untouched])


@pytest.fixture(scope="module")
def disp_volume(case):
    """JAX's MVSNet volume of the scene with its planes linear in
    disparity."""
    from mvsnerf_tpu.models import mvsnet_apply
    imgs_norm, projs, nf, _ = case["scene"].read_source_views()
    return np.asarray(mvsnet_apply(
        case["mvs"], jnp.asarray(imgs_norm), jnp.asarray(projs),
        jnp.asarray(nf), pad=PAD, lindisp=True, warp_mode="packed",
        costreg_impl="plain", featurenet_impl="plain")[0])


def test_use_disp_builds_the_volume_linear_in_disparity(case, disp_volume,
                                                        tmp_path):
    from mvsnerf_tpu.io.torch_ckpt import export_reference_checkpoint
    ckpt = str(tmp_path / "weights.tar")  # no volume: the port builds it
    export_reference_checkpoint(ckpt, case["mlp"], case["mvs"])
    vol = _system(case, ckpt, "--use_disp").volume.detach().numpy()
    tol = 1e-4 * (1 + np.abs(disp_volume).max())
    _close(vol, disp_volume, tol)
    assert np.abs(disp_volume - case["volume"]).max() > 10 * tol


def test_use_disp_step_matches_jax(case, disp_volume, tmp_path):
    from mvsnerf_tpu.io.torch_ckpt import export_reference_checkpoint
    ckpt = str(tmp_path / "disp.tar")
    export_reference_checkpoint(ckpt, case["mlp"], case["mvs"],
                                volume=disp_volume)
    port = _system(case, ckpt, "--use_disp")
    stepper = _jax_stepper(case, disp_volume, lindisp=True)
    _check_first_step(case, _step_runs(case, port, stepper,
                                       case["batches"][:1]))


# ----------------------------------------------------------------- fit ---

class _Log:
    def log_scalars(self, step, scalars):
        pass


def _spied(system, events):
    """Record the order of `system`'s refreshes, steps and validations."""
    refresh, step = system.update_density_volume, system._step

    def spy_refresh():
        events.append("refresh")
        refresh()

    def spy_step(*a, **k):
        events.append("step")
        return step(*a, **k)

    system.update_density_volume = spy_refresh
    system._step = spy_step
    system.validate = lambda step_i, logger: events.append(("val", step_i))
    return system


def test_fit_refreshes_every_200_steps_and_validates_off_them(case):
    events = []
    system = _spied(_system(case, extra=DENSITY), events)
    system.fit(num_steps=201, start_step=198, logger=_Log(), val_every=99)
    # no refresh at 198 or 199 (as after a resume: the density volume is
    # not in a snapshot); at 200; validation 100 steps off (199 - 100)
    assert events == ["step", "step", ("val", 199), "refresh", "step"]
    assert system.density_volume is not None
    events.clear()
    system.fit(num_steps=2, val_every=0)
    assert events == ["refresh", "step", "step"]
    # without the density volume: no refresh, validation on the multiples
    events.clear()
    _spied(_system(case), events).fit(num_steps=201, start_step=198,
                                      logger=_Log(), val_every=99)
    assert events == ["step"] * 3


# -------------------------------------------------------------- render ---

def test_tiled_render_with_density_matches_jax(case, monkeypatch):
    """`render_image` in the tiled mode with the density volume (K6b's
    twin over the 8 channels joined to the colours baked at set-up, 24
    samples, the importance draws from a generator seeded 1) against
    JAX's exact baked render at the depths the port drew."""
    from mvsnerf_tpu.render.renderer import render_rays
    from mvsnerf_tpu_torch.render import tiled
    from mvsnerf_tpu_torch.render.renderer import sample_rays
    system = _system(case, extra=DENSITY + " --render_mode tiled")
    system.update_density_volume()
    seen = []

    def spy(pts_ndc, *a):
        seen.append(pts_ndc.shape[1])
        return render_v0(pts_ndc, *a)

    render_v0 = tiled.render_v0
    monkeypatch.setattr(tiled, "render_v0", spy)
    rays = case["scene"].all_rays[:H * W]
    out = system.render_image(rays, chunk=H * W)
    assert seen == [N_SAMPLES + N_IMP]
    pose = system.pose_source
    _, rays_d, z, ndc = sample_rays(
        t(rays), N_SAMPLES, pose["w2cs"][0], pose["intrinsics"][0], (H, W),
        system.near_far, PAD, generator=torch.Generator().manual_seed(1),
        density_volume=system.density_volume, n_importance=N_IMP)
    vol20 = torch.cat([system.volume.detach(), system.color_feature], -1)
    ref = render_rays(case["mlp"], jnp.asarray(vol20.numpy()), None,
                      jnp.asarray(ndc.numpy()), jnp.asarray(z.numpy()),
                      jnp.asarray(rays_d.numpy()),
                      w2c_ref=jnp.asarray(pose["w2cs"][0].numpy()),
                      use_color_volume=True)
    assert 0.05 < float(np.asarray(ref["acc"]).mean()) < 0.999
    for k, tol in (("rgb", 1e-5), ("acc", 1e-5), ("depth", 5e-5)):
        _close(out[k], ref[k], tol, k)


def test_cached_tiled_renderer_follows_the_density_refresh(case):
    system = _system(case, extra=DENSITY + " --render_mode tiled")
    rays = case["scene"].all_rays[:256]

    def render():
        return system.render_image(rays, chunk=256)["rgb"], \
            system._tiled_cache[2]

    before, fn0 = render()  # no density volume yet: 16 samples
    assert render()[1] is fn0
    system.update_density_volume()
    first, fn1 = render()
    assert fn1 is not fn0 and not torch.allclose(first, before)
    assert render()[1] is fn1
    # a refresh replaces the tensor; an in-place change bumps its version
    system.update_density_volume()
    again, fn2 = render()
    assert fn2 is not fn1 and torch.equal(again, first)
    with torch.no_grad():
        system.density_volume.mul_(3.0)
    third, fn3 = render()
    assert fn3 is not fn2 and not torch.allclose(third, first)


# ----------------------------------------------------------------- CLI ---

def test_finetune_cli_density_and_disp_trains_and_resumes(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    from mvsnerf_tpu_torch import train_finetune
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        from make_synthetic_scene import make_scene
    finally:
        sys.path.pop(0)
    make_scene(str(tmp_path / "dtu"))
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset_name", "dtu_ft", "--datadir",
            str(tmp_path / "dtu" / "scan1"), "--expname", "density",
            "--with_rgb_loss", "--use_density_volume", "--N_importance",
            str(N_IMP), "--use_disp", "--imgScale_train", "0.1",
            "--imgScale_test", "0.1", "--pad", "4", "--N_samples", "16",
            "--batch_size", "128", "--device", "cpu"]
    train_finetune.main(argv + ["--max_steps", "2"])
    train_finetune.main(argv + ["--max_steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 2" in out
    assert out.count("val view") == 8
    psnrs = [float(line.rsplit(" ", 1)[1]) for line in out.splitlines()
             if line.startswith("val view")]
    assert all(np.isfinite(psnrs))
    with open(tmp_path / "runs_fine_tuning" / "density" / "metrics.csv") as f:
        assert "val/PSNR" in f.readline()

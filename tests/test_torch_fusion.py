"""The port's fusion fine-tune trainer against the JAX package, on the CPU
(every kernel on its plain twin), on tests/test_train.py's duck-typed
scene (5 views of 32x32, pad 4, 128 planes; the fused volume 16^3; 16
samples a ray, batches of 256 rays, perturb 0).

The scene's principal point is moved off the pixel grid by a fraction of
a pixel: the fuse renders each view's own rays at 1/4 resolution, and with
the principal point at (W/2, H/2) the first row and column of those rays
project back exactly onto the source view's border, where the in-image
mask of the colours flips on one ulp (either side is right; JAX and the
port then differ by a whole mask).

What is held, and how:
- `splat_trilinear`: the twin and the masked K5 route the card takes (on
  `volume_splat_plain`) against JAX's, on points inside, outside, on the
  upper faces and at exact corners: abs <= 1e-5 x (1 + max|JAX|) (sums in
  another order);
- one view's local render (feats, alpha, weights, pts) against JAX's
  `_local_render_chunk` on JAX's local volume: abs <= 1e-5 x (1 +
  max|JAX|), pts 1e-5 x max|pts|;
- `fuse_local_volumes`: the 22 used channels of the accumulator, each
  against JAX's (read from its `splat_trilinear` calls) within ACC_TOL x
  max|JAX| of that channel (MVSNet's and the render's float32 sums run in
  another order: ~1e-5 seen). The normalised volume and density are
  `acc / (weight + 1e-6)`, which divides those differences by the weight:
  they are held to ACC_TOL x (1 + max|JAX|) where the weight exceeds
  W_FLOOR, a hundredth of one sample's, and the voxels below it are counted
  and must be a minority;
- one step and three steps with and without `--N_importance` (loss rel
  1e-5, gradients 1e-4 x max|g|, parameters 1e-5, values whose first
  gradient is eps-sized to Adam's bound) against JAX autodiff of the exact
  gather (`render_rays(use_color_volume=True, fast_volume_grad=False,
  mlp_impl="xla")` over JAX's `ray_marcher(bbox_3d=...)` samples), never
  against JAX's `FusionFinetuneSystem._step`, whose banded VJP drops taps
  off the TPU. The importance draws are JAX's own, fed through the `u=`
  seam; rays with a sample within KINK of a ReLU kink, with an importance
  draw in an ambiguous empty bin, or whose importance depths JAX and the
  port put more than Z_AGREE apart are left out
  (tests/test_torch_density.py's rules and reasons);
- `update_density_volume` against JAX's `render_density` on the port's
  grid (abs <= 1e-5 x (1 + max|sigma|)), and the grid against JAX's
  `linspace` grid;
- `fit`'s cadence (refresh every 500 steps only with `--N_importance`,
  validation 100 steps off) and the validation panel;
- `render_image` in the tiled bbox mode against the chunked mode, and
  that against JAX's exact route over its own samples in the box, at
  perturb 0 (rgb abs <= 1e-5, depth 5e-5); JAX's chunked `render_image`
  is its banded gather's, which drops taps in the box's coordinates off
  the TPU (held to that route, and shown apart from the exact one);
- the CLI on `scripts/make_synthetic_scene.py`'s scene: trains, writes a
  snapshot, resumes.
"""

import contextlib
import copy
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_density import KEY_FINE, Z_AGREE, _ambiguous_rays, \
    _uniforms
from test_torch_finetune import KINK
from test_train import FakeSceneDataset, H, PAD, W
from torch_port_common import jax_params, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = (16, 16, 16)
N_SAMPLES, N_IMP, BATCH = 16, 8, 256
KEPT, KEPT_FINE = 96, 64
ACC_TOL, W_FLOOR = 1e-4, 1e-2
PORT_FLAGS = f"--pad {PAD} --N_samples {N_SAMPLES} --batch_size {BATCH} " \
    "--with_rgb_loss --perturb 0"


class Scene(FakeSceneDataset):
    """tests/test_train.py's scene with images from its own seed and the
    principal point off the pixel grid (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.imgs = np.random.default_rng(9).uniform(
            0.2, 0.8, self.imgs.shape).astype(np.float32)
        self.all_rgbs = self.imgs.reshape(-1, 3)
        self.intr = self.intr.copy()
        self.intr[:2, 2] += [0.37, 0.29]


def _close(ours, ref, atol, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=0,
                               atol=atol, err_msg=what)


@contextlib.contextmanager
def _volume_dim():
    """Both packages' fusion systems at DIM."""
    from mvsnerf_tpu.train import fusion as jf
    from mvsnerf_tpu_torch.train.fusion import FusionFinetuneSystem
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jf.FusionFinetuneSystem, "VOLUME_DIM", DIM)
        mp.setattr(FusionFinetuneSystem, "VOLUME_DIM", DIM)
        yield


def _jax_args(extra=""):
    from mvsnerf_tpu.config import config_parser
    return config_parser(cmd=f"{PORT_FLAGS} --ckpt None {extra}")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The scene, seeded JAX weights and a reference checkpoint of them,
    JAX's fused system (built without its initialisers) with its
    accumulators read from its `splat_trilinear` calls, and the port's
    fused system."""
    from mvsnerf_tpu.io.torch_ckpt import export_reference_checkpoint
    from mvsnerf_tpu.train import fusion as jf
    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.train.fusion import FusionFinetuneSystem
    scene = Scene()
    mlp_p, mvs_p = jax_params(0)
    ckpt = str(tmp_path_factory.mktemp("ck") / "ref.tar")
    export_reference_checkpoint(ckpt, mlp_p, mvs_p)
    calls = []
    splat = jf.splat_trilinear

    def spy(volume, weights, pts, feats):
        out = splat(volume, weights, pts, feats)
        calls.append([np.asarray(a) for a in out])
        return out

    ref = jf.FusionFinetuneSystem.__new__(jf.FusionFinetuneSystem)
    ref.args, ref.train_dataset, ref.val_dataset = _jax_args(), scene, None
    ref.mlp, ref.mvsnet = mlp_p, mvs_p
    ref.bbox_3d = jnp.asarray(scene.bbox_3d)
    with _volume_dim(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jf, "splat_trilinear", spy)
        ref.fuse_local_volumes()
        port = FusionFinetuneSystem(
            config_parser(f"{PORT_FLAGS} --ckpt {ckpt}"), scene,
            device="cpu")
    # the last view's two calls: (volume, _), then (sigma, weights)
    acc = np.concatenate([calls[-2][0], *calls[-1]], -1)
    return dict(scene=scene, mlp=mlp_p, mvs=mvs_p, ckpt=ckpt, ref=ref,
                acc=acc, port=port)


def _port(case, extra=""):
    """A copy of the case's fused port system with `extra` flags (the fuse
    reads none of them)."""
    from mvsnerf_tpu_torch.config import config_parser
    system = copy.deepcopy(case["port"])
    system.args = config_parser(f"{PORT_FLAGS} --ckpt {case['ckpt']} "
                                f"{extra}")
    system._build_optimizer()  # a copied scheduler would not see Adam's step
    return system


# -------------------------------------------------------------- splat ---

def _splat_points(seed=4):
    """(40, 8, 3) points: uniform over [-0.1, 1.1] (some outside), then
    points on the upper faces, at exact corners and at 0 and 1 exactly."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.1, 1.1, (40, 8, 3)).astype(np.float32)
    p[0, :, 0] = 1.0                                       # upper x face
    p[1, :, 1] = 1.0
    p[2, :, 2] = 1.0
    p[3] = np.array([[i / 15, j / 15, k / 15] for i, j, k in
                     rng.integers(0, 16, (8, 3))], np.float32)  # corners
    p[4, :4] = 0.0
    p[4, 4:] = 1.0
    p[5] = np.clip(p[5], 0.0, 1.0)
    return p


@pytest.mark.parametrize("route", ["twin", "masked K5 route"])
def test_splat_trilinear_matches_jax(route):
    from mvsnerf_tpu.train.fusion import splat_trilinear as jax_splat
    from mvsnerf_tpu_torch.ops.volume_gather import volume_splat_plain
    from mvsnerf_tpu_torch.train.fusion import splat_keep, splat_trilinear
    pts = _splat_points()
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((40, 8, 7)).astype(np.float32)
    vol0 = rng.standard_normal((16, 12, 10, 7)).astype(np.float32)
    w0 = np.zeros((16, 12, 10, 1), np.float32)
    ref, ref_w = (np.asarray(a) for a in jax_splat(
        jnp.asarray(vol0), jnp.asarray(w0), jnp.asarray(pts.reshape(-1, 3)),
        jnp.asarray(vals.reshape(-1, 7))))
    ones = np.ones((40, 8, 1), np.float32)
    acc = t(np.concatenate([vol0, w0], -1))
    both = t(np.concatenate([vals, ones], -1))
    keep = splat_keep(t(pts), acc.shape)
    # JAX's rule: the faces at 1 and points outside drop, 0 stays
    assert not keep[0].any() and not keep[4, 4:].any() and keep[4, :4].all()
    assert 0.3 < float(keep.float().mean()) < 0.9
    if route == "twin":
        out = splat_trilinear(acc, t(pts), both)
        assert out is acc  # in place
    else:  # the card's route on K5's twin: rows of dropped samples zeroed
        g = both * keep[..., None]
        out = acc + volume_splat_plain(g, t(pts), acc)
    want = np.concatenate([ref, ref_w], -1)
    _close(out, want, 1e-5 * (1 + np.abs(want).max()))
    assert np.abs(ref - vol0).max() > 0.1


# --------------------------------------------------------------- fuse ---

def _view_sources(scene, i):
    """View i's rays at 1/4 resolution and its 3 nearest views' sources, as
    `fuse_local_volumes` picks them."""
    from mvsnerf_tpu.data.dtu_ft import rays_for_pose
    pairs = np.asarray(scene.pair_idx[0])
    c2ws = scene.load_poses_all()[pairs]
    dis = np.sum(np.abs(c2ws[:, :3, 3] - c2ws[i][:3, 3:].T), -1)
    imgs, projs, nf, pose = scene.read_source_views(
        pair_idx=pairs[np.argsort(dis)[:3]])
    h4, w4 = H // 4, W // 4
    rays = rays_for_pose(h4, w4, [f / 4 for f in scene.focal],
                         [w4 / 2, h4 / 2], c2ws[i], nf[0], nf[1])
    return rays, imgs, projs, nf, pose


def test_local_render_matches_jax(case):
    from mvsnerf_tpu.models import mvsnet_apply
    from mvsnerf_tpu.train.common import unpreprocess_images
    scene, ref, port = case["scene"], case["ref"], case["port"]
    rays, imgs, projs, nf, pose = _view_sources(scene, 1)
    volume = np.asarray(mvsnet_apply(
        case["mvs"], jnp.asarray(imgs), jnp.asarray(projs),
        jnp.asarray(nf, jnp.float32), pad=PAD)[0])
    imgs01 = unpreprocess_images(jnp.asarray(imgs))
    want = ref._local_render_chunk(
        jnp.asarray(volume), {k: jnp.asarray(v) for k, v in pose.items()},
        imgs01, np.asarray(nf))(jnp.asarray(rays))
    with torch.no_grad():
        got = port._local_render_chunk(
            t(volume), {k: t(v) for k, v in pose.items()},
            t(np.asarray(imgs01)), t(nf), t(rays))
    assert got["feats"].shape == (len(rays), 128, 20)
    for k in ("feats", "alpha", "weights"):
        w = np.asarray(want[k])
        _close(got[k], w, 1e-5 * (1 + np.abs(w).max()), k)
    _close(got["pts"], want["pts"], 1e-5 * np.abs(want["pts"]).max())
    # the renders see the volume: some rays are opaque, some alphas > 0
    assert 0.01 < float((got["alpha"] > 0.05).float().mean()) < 0.99


def test_fuse_local_volumes_matches_jax(case):
    ref, port, acc = case["ref"], case["port"], case["acc"]
    ours = port.fuse_acc.numpy()
    assert ours.shape == (*DIM, 24) and not ours[..., 22:].any()
    scale = np.abs(acc).max(axis=(0, 1, 2))
    assert scale.min() > 0
    err = np.abs(ours[..., :22] - acc).max(axis=(0, 1, 2))
    assert (err <= ACC_TOL * scale).all(), err / scale
    weight = acc[..., 21]
    firm = weight > W_FLOOR
    # the grid is mostly covered; the voxels below the floor are left out
    assert 0.5 < firm.mean() < 1.0, firm.mean()
    vol, dens = np.asarray(ref.volume), np.asarray(ref.density_volume)
    assert port.volume.shape == vol.shape == (*DIM, 20)
    _close(port.volume.detach().numpy()[firm], vol[firm],
           ACC_TOL * (1 + np.abs(vol).max()), "volume")
    _close(port.density_volume.numpy()[firm], dens[firm],
           ACC_TOL * (1 + np.abs(dens).max()), "density")
    assert isinstance(port.volume, torch.nn.Parameter)
    # the first view's sources are the reference pose of the view dirs
    np.testing.assert_array_equal(port.pose_source["w2cs"].numpy(),
                                  np.asarray(ref.pose_source_ref["w2cs"]))


# -------------------------------------------------------------- steps ---

def _jax_stepper(case, volume, density=None):
    """The JAX reference step (jitted; exact gather, autodiff) in the box's
    coordinates, with JAX's importance step over `density` when given; the
    schedule at fusion.py:212-213's default length."""
    from mvsnerf_tpu.ops.sampling import ray_marcher, ray_marcher_fine
    from mvsnerf_tpu.render.renderer import render_rays
    from mvsnerf_tpu.utils.schedulers import make_lr_schedule
    bbox = jnp.asarray(case["scene"].bbox_3d)
    w2c_ref = jnp.asarray(case["ref"].pose_source_ref["w2cs"][0])

    def samples(rays):
        pts, _, rays_d, z = ray_marcher(jax.random.PRNGKey(0), rays,
                                        N_SAMPLES, perturb=0.0, bbox_3d=bbox)
        ndc = (pts - bbox[0]) / (bbox[1] - bbox[0])
        if density is not None:
            pts, _, rays_d, z = ray_marcher_fine(
                KEY_FINE, rays, jnp.asarray(density), z, ndc, N_IMP)
            ndc = (pts - bbox[0]) / (bbox[1] - bbox[0])
        return pts, ndc, z, rays_d

    def loss_fn(params, rays, rgbs):
        pts, ndc, z, rays_d = samples(rays)
        out = render_rays(params["mlp"], params["volume"], pts, ndc, z,
                          rays_d, w2c_ref=w2c_ref, use_color_volume=True,
                          fast_volume_grad=False, mlp_impl="xla")
        return jnp.mean((out["rgb"] - rgbs) ** 2)

    args = _jax_args()
    opt = optax.adam(make_lr_schedule(args.lrate, args.lr_scheduler,
                                      args.decay_step, args.decay_gamma),
                     b1=0.9, b2=0.999)

    @jax.jit
    def step(params, opt_state, rays, rgbs):
        loss, grads = jax.value_and_grad(loss_fn)(params, rays, rgbs)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    params = {"mlp": case["mlp"], "volume": jnp.asarray(volume)}
    depths = jax.jit(lambda rays: samples(rays)[2])
    return step, params, opt.init(params), \
        lambda rays: np.asarray(depths(jnp.asarray(rays)))


def _clear(port, rays, u):
    """(N,) bool: rays whose samples (importance draws `u` (N, N_IMP) with
    the density volume, or none) all lie more than KINK from every ReLU
    kink of the MLP and draw in no ambiguous empty bin."""
    from mvsnerf_tpu_torch.ops.mlp_train import relu_margin
    with contextlib.ExitStack() as stack:
        if u is not None:
            stack.enter_context(_uniforms(u))
        x = port.mlp_input(t(rays))
    ok = (relu_margin(port.mlp, x).reshape(len(rays), -1).amin(1) >
          KINK).numpy()
    if u is not None:
        from mvsnerf_tpu_torch.render.renderer import sample_rays
        _, _, z, ndc = sample_rays(t(rays), N_SAMPLES, None, None, None,
                                   None, None, bbox=port.bbox)
        ok &= ~_ambiguous_rays(port.density_volume, z, ndc, u)
    return ok


def _kept(port, jax_depths, rays, u, n):
    """`n` rays of a batch for a step whose i-th ray draws with u[i]: each
    clear (`_clear`, with its own slot's draws), and, with draws, with
    importance depths that JAX's float32 route and the port's put within
    Z_AGREE of each other. A slot whose ray fails takes the next unused
    ray that passes."""
    unused = iter(range(len(rays)))

    def take(i):
        for r in unused:
            if _clear(port, rays[r:r + 1],
                      None if u is None else u[i:i + 1])[0]:
                return r
        raise AssertionError("too few rays clear of the kinks")

    slots = [take(i) for i in range(n)]
    while u is not None:
        with _uniforms(u[:n]):
            z = port._samples(t(rays[slots]), None)[2].numpy()
        far = np.flatnonzero(np.abs(z - jax_depths(rays[slots])).max(-1) >
                             Z_AGREE)
        if not len(far):
            break
        for i in far:
            slots[i] = take(i)
    return np.array(slots)


def _step_runs(case, extra, density):
    """3 steps of the port and of JAX from the port's fused state on the
    same kept rays of 3 batches; the first step's gradients, each value's
    first nonzero gradient and the final parameters."""
    from mvsnerf_tpu.train.common import RayBatchIterator
    from mvsnerf_tpu_torch.io.torch_ckpt import state_dicts_from_jax
    port = _port(case, extra)
    kept = KEPT_FINE if density else KEPT
    dens = port.density_volume.numpy() if density else None
    step, params, opt_state, depths = _jax_stepper(
        case, port.volume.detach().numpy(), dens)
    u = np.asarray(jax.random.uniform(KEY_FINE, (kept, N_IMP))) \
        if density else None
    scene = case["scene"]
    it = RayBatchIterator({"rays": scene.all_rays, "rgbs": scene.all_rgbs},
                          1024 if density else BATCH, seed=0)
    out = {"port_loss": [], "jax_loss": [], "volume0":
           port.volume.detach().numpy().copy()}
    for _ in range(3):
        b = next(it)
        keep = _kept(port, depths, b["rays"], u, kept)
        rays, rgbs = b["rays"][keep], b["rgbs"][keep]
        params, opt_state, loss, grads = step(params, opt_state,
                                              jnp.asarray(rays),
                                              jnp.asarray(rgbs))
        out["jax_loss"].append(float(loss))
        with contextlib.ExitStack() as stack:
            if u is not None:
                stack.enter_context(_uniforms(u))
            out["port_loss"].append(float(port._step(t(rays), t(rgbs))))
        g = {"volume": np.abs(np.asarray(grads["volume"])), **{
            n: v.abs().numpy() for n, v in
            state_dicts_from_jax(grads["mlp"], case["mvs"])[0].items()}}
        first = out.setdefault("gfirst", {n: np.zeros_like(v)
                                          for n, v in g.items()})
        for n, v in g.items():
            first[n] = np.where(first[n] == 0, v, first[n])
        if "jax_grads" not in out:
            out["jax_grads"] = {
                "volume": np.asarray(grads["volume"]),
                **state_dicts_from_jax(grads["mlp"], case["mvs"])[0]}
            out["port_grads"] = {
                "volume": port.volume.grad.clone(),
                **{n: p.grad.clone() for n, p in port.mlp.named_parameters()}}
    out["jax_params"] = {"volume": np.asarray(params["volume"]),
                         **state_dicts_from_jax(params["mlp"],
                                                case["mvs"])[0]}
    out["port"] = port
    return out


@pytest.fixture(scope="module", params=["coarse", "importance"])
def runs(case, request):
    density = request.param == "importance"
    return _step_runs(case, f"--N_importance {N_IMP}" if density else "",
                      density)


def test_fusion_one_step_matches_jax(runs):
    loss, ref = runs["port_loss"][0], runs["jax_loss"][0]
    assert abs(loss - ref) <= 1e-5 * abs(ref)
    for name, g in runs["jax_grads"].items():
        g = np.asarray(g)
        assert np.abs(g).max() > 0, name
        _close(runs["port_grads"][name], g, 1e-4 * np.abs(g).max(), name)


def test_fusion_three_steps_match_jax(runs):
    for loss, ref in zip(runs["port_loss"], runs["jax_loss"]):
        assert abs(loss - ref) <= 1e-5 * abs(ref)
    assert len(set(runs["jax_loss"])) == 3
    system, ref = runs["port"], runs["jax_params"]
    ours = {"volume": system.volume, **dict(system.mlp.named_parameters())}
    # Adam's first update of a value whose first gradient is eps-sized is
    # up to lr apart (ROADMAP.md, "ReLU kinks and Adam's eps"): those
    # values are held to Adam's bound of lr a step
    lr = system.args.lrate
    for name, p in ours.items():
        p, r = p.detach().numpy(), np.asarray(ref[name])
        firm = runs["gfirst"][name] > 1e-7
        _close(p[firm], r[firm], 1e-5, name)
        _close(p, r, 3 * lr, name)
    gfirst = runs["gfirst"]["volume"]
    firm, untouched = gfirst > 1e-7, gfirst == 0
    assert firm.mean() > 0.05 and (firm | untouched).mean() > 0.9
    np.testing.assert_array_equal(
        system.volume.detach().numpy()[untouched],
        runs["volume0"][untouched])
    # Adam holds the MLP and the volume only
    held = {id(p) for g in system.optimizer.param_groups for p in g["params"]}
    assert id(system.volume) in held and not any(
        id(p) in held for p in system.mvsnet.parameters())


# ------------------------------------------------------------ density ---

def test_update_density_volume_matches_jax(case):
    from mvsnerf_tpu.render.renderer import render_density
    from mvsnerf_tpu_torch.train.fusion import voxel_grid
    port = _port(case, f"--N_importance {N_IMP}")
    fused = port.density_volume
    port.update_density_volume()
    dv = port.density_volume.numpy()
    assert dv.shape == (*DIM, 1) and port.density_volume is not fused
    # JAX's grid (fusion.py:270-275)
    lin = jnp.linspace(0, 1, DIM[0])
    gz, gy, gx = jnp.meshgrid(lin, lin, lin, indexing="ij")
    grid = np.asarray(jnp.stack([gx, gy, gz], -1).reshape(-1, 3))
    np.testing.assert_array_equal(voxel_grid(DIM).numpy(), grid)
    feats = port.volume.detach().numpy().reshape(-1, 20)
    ref = np.asarray(render_density(case["mlp"], jnp.asarray(grid),
                                    jnp.asarray(feats))).reshape(dv.shape)
    assert (ref > 0).mean() > 0.05 and np.ptp(ref) > 1e-2
    _close(dv, ref, 1e-5 * (1 + np.abs(ref).max()))


# ---------------------------------------------------------------- fit ---

class _Log:
    def log_scalars(self, step, scalars):
        pass


def _spied(system, events):
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


@pytest.mark.parametrize("extra,want", [
    (f"--N_importance {N_IMP}",
     ["step", "step", ("val", 499), "refresh", "step", "step"]),
    # --use_density_volume alone refreshes nothing in the fusion trainer,
    # and validation falls on the multiples of val_every
    ("--use_density_volume", ["step", "step", "step", "step"])])
def test_fit_refreshes_every_500_steps_with_n_importance(case, extra, want):
    events = []
    system = _spied(_port(case, extra), events)
    system.fit(num_steps=502, start_step=498, logger=_Log(), val_every=399)
    assert events == want
    events.clear()
    system.fit(num_steps=1, val_every=0)
    assert events == (["refresh", "step"] if "N_imp" in extra else ["step"])


def test_validate_writes_the_panel(case, tmp_path):
    from mvsnerf_tpu_torch.utils.logging import MetricLogger
    system = _port(case)
    system.val_dataset = case["scene"]
    logger = MetricLogger(str(tmp_path))
    psnr = system.validate(7, logger, chunk=512)
    assert np.isfinite(psnr)
    import imageio.v2 as imageio
    panel = imageio.imread(tmp_path / "val_00_00000007.png")
    assert panel.shape == (H, 3 * W, 3)
    with open(tmp_path / "metrics.csv") as f:
        assert "val/PSNR" in f.readline()


# ------------------------------------------------------------- render ---

def test_tiled_bbox_render_matches_chunked_and_jax(case, monkeypatch):
    from mvsnerf_tpu_torch.render import tiled
    port = _port(case, "--render_mode tiled")
    seen = []

    def spy(pts_ndc, z, colors, dirs, volume, mlp):
        seen.append(tuple(volume.shape))
        return render_v0(pts_ndc, z, colors, dirs, volume, mlp)

    render_v0 = tiled.render_v0
    monkeypatch.setattr(tiled, "render_v0", spy)
    rays = case["scene"].all_rays[:H * W]
    out_t = port.render_image(rays, chunk=512)
    assert seen == [(*DIM, 20)] * 2
    port.args.render_mode = "chunked"
    out_c = port.render_image(rays, chunk=512)
    ref = case["ref"]
    ref.args = _jax_args()
    ref.params = {"mlp": case["mlp"],
                  "volume": jnp.asarray(port.volume.detach().numpy())}
    ref._build_step()
    out_j = ref.render_image(rays, chunk=512)
    # JAX's exact route over its own samples in the box: what its
    # `render_image` computes, but for the banded gather it resolves to off
    # the TPU, which drops taps in the box's coordinates in the forward too
    # (ROADMAP.md, "Silent tap drops")
    from mvsnerf_tpu.ops.sampling import ray_marcher
    from mvsnerf_tpu.ops.volume_grad import volume_band_width
    from mvsnerf_tpu.render.renderer import render_rays
    bbox = jnp.asarray(case["scene"].bbox_3d)
    pts, _, rays_d, z = ray_marcher(jax.random.PRNGKey(0), jnp.asarray(rays),
                                    N_SAMPLES, perturb=0.0, bbox_3d=bbox)
    exact, banded = (render_rays(
        case["mlp"], ref.params["volume"], pts,
        (pts - bbox[0]) / (bbox[1] - bbox[0]), z, rays_d,
        w2c_ref=ref.pose_source_ref["w2cs"][0], use_color_volume=True,
        fast_volume_grad=fast, mlp_impl="xla",
        volume_band_k=volume_band_width(DIM[0], N_SAMPLES, 0))
        for fast in (False, True))
    assert 0.05 < float(out_t["acc"].mean()) < 0.999
    for k, tol in (("rgb", 1e-5), ("depth", 5e-5)):  # chunked: these two
        _close(out_t[k], out_c[k], tol, k)
        _close(out_c[k], exact[k], tol, k)
        _close(out_j[k], banded[k], tol, k)
    assert np.abs(np.asarray(out_j["rgb"] - exact["rgb"])).max() > 1e-4
    # the box is keyed by value: a copy of it reuses the bake
    fn = port._tiled_cache[2]
    port.args.render_mode = "tiled"
    port.bbox = port.bbox.clone()
    port.render_image(rays[:64], chunk=512)
    assert port._tiled_cache[2] is fn
    with pytest.raises(ValueError):
        tiled.make_tiled_renderer(port.mlp, port.volume[..., :8], None, None,
                                  port.pose_source, 16, PAD, bbox=port.bbox)


# ---------------------------------------------------------------- CLI ---

def test_fusion_cli_trains_and_resumes(tmp_path, monkeypatch, capsys):
    from mvsnerf_tpu_torch import train_fusion
    from mvsnerf_tpu_torch.io.checkpoint import latest_checkpoint
    from mvsnerf_tpu_torch.train.fusion import FusionFinetuneSystem
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        from make_synthetic_scene import make_scene
    finally:
        sys.path.pop(0)
    make_scene(str(tmp_path / "dtu"))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(FusionFinetuneSystem, "VOLUME_DIM", DIM)
    argv = ["--dataset_name", "dtu_ft", "--datadir",
            str(tmp_path / "dtu" / "scan1"), "--expname", "fusion",
            "--with_rgb_loss", "--imgScale_train", "0.1",
            "--imgScale_test", "0.1", "--pad", "4", "--N_samples", "16",
            "--N_importance", "8", "--batch_size", "128", "--device", "cpu"]
    train_fusion.main(argv + ["--max_steps", "2"])
    ckpts = tmp_path / "runs_fine_tuning" / "fusion" / "ckpts"
    assert latest_checkpoint(str(ckpts))[0] == 2
    train_fusion.main(argv + ["--max_steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 2" in out
    assert latest_checkpoint(str(ckpts))[0] == 3
    losses = [line for line in out.splitlines() if line.startswith("steps")]
    assert len(losses) == 2 and "nan" not in losses[-1]
    # without --device cpu it asks for the card, and there is none here
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_fusion.main(argv[:-2] + ["--max_steps", "1"])

"""The port's fine-tune trainer against the JAX package, on the CPU, on a
tiny in-memory scene (5 views of 32x32, pad 4, 128 planes, 16 samples,
batches of 256 rays, perturb 0).

The JAX reference step is `render_rays(..., fast_volume_grad=False,
mlp_impl="xla")` (JAX autodiff of the exact `index_point_feature`, not the
banded VJP that `FinetuneSystem._step` resolves to off the TPU) plus
`optax.adam(make_lr_schedule(...))`, from the same weights and volume: the
JAX parameters and volume go to the port through a reference-format
checkpoint. Tolerances: loss rel <= 1e-5; gradients abs <= 1e-4 x max|g|;
parameters after 3 steps abs <= 1e-5. Also here: the schedules against
optax, the batch iterator, snapshots and resume, the checkpoint's volume,
the refused options and the flag surface.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from torch_port_common import jax_params

H = W = 32
PAD, N_SAMPLES, BATCH = 4, 16, 256
NEAR_FAR = [2.0, 6.0]
KINK, KEPT = 5e-6, 160


class Scene:
    """Duck-typed per-scene dataset (the shape of tests/test_train.py's):
    flat ray buffers and 3 source views, all numpy."""

    def __init__(self, n_views=5, seed=9):
        from mvsnerf_tpu_torch.data.common import normalize_imagenet
        from mvsnerf_tpu_torch.data.dtu_ft import rays_for_pose
        rng = np.random.default_rng(seed)
        self.intr = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]],
                             np.float32)
        w2cs = []
        for i in range(n_views):
            a = 0.08 * (i - n_views / 2)
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                         [-np.sin(a), 0, np.cos(a)]]
            m[:3, 3] = [0.15 * (i - n_views / 2), 0, 0]
            w2cs.append(m)
        self.w2cs = np.stack(w2cs)
        self.imgs = rng.uniform(0.2, 0.8, (n_views, H, W, 3)).astype(
            np.float32)
        # training rays from the views that are not source views: a ray
        # through a source view's own pixel grid projects back onto its
        # border exactly, where the in-image mask flips on one ulp
        self.all_rays = np.concatenate([
            rays_for_pose(H, W, [40.0, 40.0], [W / 2, H / 2],
                          np.linalg.inv(m), *NEAR_FAR) for m in self.w2cs[3:]])
        self.all_rgbs = self.imgs[3:].reshape(-1, 3)
        self.norm = normalize_imagenet

    def read_source_views(self, pair_idx=None):
        idx = [0, 1, 2]
        intr_s4 = self.intr.copy()
        intr_s4[:2] /= 4
        p4 = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
        p4[:, :3] = intr_s4 @ self.w2cs[idx][:, :3]
        projs = (p4 @ np.linalg.inv(p4[0]))[:, :3].astype(np.float32)
        pose = {"w2cs": self.w2cs[idx],
                "c2ws": np.linalg.inv(self.w2cs[idx]).astype(np.float32),
                "intrinsics": np.stack([self.intr] * 3)}
        return (self.norm(self.imgs[idx]).astype(np.float32), projs,
                list(NEAR_FAR), pose)


def _port_args(ckpt, extra=""):
    from mvsnerf_tpu_torch.config import config_parser
    return config_parser(f"--pad {PAD} --N_samples {N_SAMPLES} "
                         f"--batch_size {BATCH} --with_rgb_loss --perturb 0 "
                         f"--ckpt {ckpt} {extra}")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """JAX weights, the JAX volume of the scene, a reference checkpoint
    holding all three, and 3 batches from the JAX iterator."""
    from mvsnerf_tpu.io.torch_ckpt import export_reference_checkpoint
    from mvsnerf_tpu.models import mvsnet_apply
    from mvsnerf_tpu.train.common import RayBatchIterator
    scene = Scene()
    mlp_p, mvs_p = jax_params(0)
    imgs_norm, projs, nf, _ = scene.read_source_views()
    volume = np.asarray(mvsnet_apply(
        mvs_p, jnp.asarray(imgs_norm), jnp.asarray(projs), jnp.asarray(nf),
        pad=PAD, warp_mode="packed", costreg_impl="plain",
        featurenet_impl="plain")[0])
    ckpt = str(tmp_path_factory.mktemp("ck") / "ref.tar")
    export_reference_checkpoint(ckpt, mlp_p, mvs_p, volume=volume)
    it = RayBatchIterator({"rays": scene.all_rays, "rgbs": scene.all_rgbs},
                          BATCH, seed=0)
    batches = [next(it) for _ in range(3)]
    return dict(scene=scene, mlp=mlp_p, mvs=mvs_p, volume=volume,
                ckpt=ckpt, batches=batches)


def _jax_stepper(case, net_type="v0", mlp=None):
    """The JAX reference step (jitted) and its initial state, for the MLP
    of `net_type` (`mlp`, else the case's v0 weights)."""
    from mvsnerf_tpu.ops.geometry import get_ndc_coordinate
    from mvsnerf_tpu.ops.sampling import ray_marcher
    from mvsnerf_tpu.render.renderer import render_rays
    from mvsnerf_tpu.train.common import unpreprocess_images
    from mvsnerf_tpu.utils.schedulers import make_lr_schedule
    imgs_norm, _, nf, pose = case["scene"].read_source_views()
    imgs = unpreprocess_images(jnp.asarray(imgs_norm))
    w2cs, intrs = jnp.asarray(pose["w2cs"]), jnp.asarray(pose["intrinsics"])
    near_far = jnp.asarray(nf, jnp.float32)
    inv_scale = jnp.asarray([W - 1.0, H - 1.0])

    def loss_fn(params, rays, rgbs):
        pts, _, rays_d, z = ray_marcher(jax.random.PRNGKey(0), rays,
                                        N_SAMPLES, perturb=0.0)
        ndc = get_ndc_coordinate(w2cs[0], intrs[0], pts, inv_scale,
                                 near=near_far[0], far=near_far[1], pad=PAD)
        out = render_rays(params["mlp"], params["volume"], pts, ndc, z,
                          rays_d, w2c_ref=w2cs[0], w2cs=w2cs,
                          intrinsics=intrs, imgs=imgs, net_type=net_type,
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

    params = {"mlp": case["mlp"] if mlp is None else mlp,
              "volume": jnp.asarray(case["volume"]), "mvsnet": case["mvs"]}
    return step, params, opt.init(params)


def _port_system(case, extra=""):
    from mvsnerf_tpu_torch.train.finetune import FinetuneSystem
    return FinetuneSystem(_port_args(case["ckpt"], extra), case["scene"],
                          device="cpu")


def _port_step(system, batch):
    return float(system._step(torch.from_numpy(batch["rays"]),
                              torch.from_numpy(batch["rgbs"])))


@pytest.fixture(scope="module")
def runs(case):
    """3 steps of the port and of JAX on the same batches. Each batch keeps
    its first KEPT rays whose samples all lie more than KINK from every
    ReLU kink of the MLP at that step's state (float64, `relu_margin`):
    float32 rounding (~1e-7 here) may put a sample on either side of a
    kink, and its gradient then differs by design."""
    from mvsnerf_tpu_torch.ops.mlp_train import relu_margin
    port = _port_system(case)
    mvs_before = {k: v.clone() for k, v in port.mvsnet.state_dict().items()}
    step, params, opt_state = _jax_stepper(case)
    out = {"port_loss": [], "jax_loss": []}
    for b in case["batches"]:
        margin = relu_margin(port.mlp, port.mlp_input(
            torch.from_numpy(b["rays"]))).reshape(len(b["rays"]), -1)
        keep = np.flatnonzero((margin.amin(1) > KINK).numpy())[:KEPT]
        assert len(keep) == KEPT
        batch = {k: v[keep] for k, v in b.items()}
        params, opt_state, loss, grads = step(
            params, opt_state, jnp.asarray(batch["rays"]),
            jnp.asarray(batch["rgbs"]))
        out["jax_loss"].append(float(loss))
        out["port_loss"].append(_port_step(port, batch))
        g = np.abs(np.asarray(grads["volume"]))
        first = out.get("vol_gfirst", np.zeros_like(g))
        out["vol_gfirst"] = np.where(first == 0, g, first)
        if "jax_grads" not in out:
            out["jax_grads"] = jax.tree.map(np.asarray, grads)
            out["port_grads"] = {
                "volume": port.volume.grad.clone(),
                **{n: p.grad.clone() for n, p in port.mlp.named_parameters()}}
            out["mvsnet_grads"] = [p.grad for p in port.mvsnet.parameters()]
    out["jax_params"] = jax.tree.map(np.asarray, params)
    out["port"] = port
    out["mvs_before"] = mvs_before
    return out


def test_finetune_starts_from_the_checkpoint_volume(case):
    system = _port_system(case)
    assert tuple(system.volume.shape) == (128, 16, 16, 8)
    np.testing.assert_array_equal(system.volume.detach().numpy(),
                                  case["volume"])


def test_finetune_one_step_matches_jax(case, runs):
    from mvsnerf_tpu_torch.io.torch_ckpt import state_dicts_from_jax
    loss, ref = runs["port_loss"][0], runs["jax_loss"][0]
    assert abs(loss - ref) <= 1e-5 * abs(ref)
    grads, ours = runs["jax_grads"], runs["port_grads"]
    gv = grads["volume"]
    assert np.abs(gv).max() > 0
    np.testing.assert_allclose(ours["volume"].numpy(), gv, rtol=0,
                               atol=1e-4 * np.abs(gv).max())
    ref_sd = state_dicts_from_jax(grads["mlp"], case["mvs"])[0]
    for name, g in ref_sd.items():
        np.testing.assert_allclose(ours[name].numpy(), g.numpy(), rtol=0,
                                   atol=1e-4 * g.abs().max().item(),
                                   err_msg=name)
    # the MVSNet is in the optimizer but never in the step
    assert all(g is None for g in runs["mvsnet_grads"])


def test_finetune_three_steps_match_jax(case, runs):
    from mvsnerf_tpu_torch.io.torch_ckpt import state_dicts_from_jax
    for loss, ref in zip(runs["port_loss"], runs["jax_loss"]):
        assert abs(loss - ref) <= 1e-5 * abs(ref)
    assert len(set(runs["jax_loss"])) == 3
    system, params = runs["port"], runs["jax_params"]
    ref_sd = state_dicts_from_jax(params["mlp"], case["mvs"])[0]
    for name, p in system.mlp.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref_sd[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    # Adam's first update of a voxel is lr * g / (|g| + 1e-8): where that
    # first gradient is near 1e-8, float32 differences of it (held above to
    # 1e-4 x max|g|) become differences of the update of up to lr, which
    # later steps carry along. Voxels whose first gradient exceeded 1e-7
    # are held to 1e-5, the rest to Adam's bound of lr per step; untouched
    # voxels must not move.
    vol = system.volume.detach().numpy()
    gfirst = runs["vol_gfirst"]
    firm, untouched = gfirst > 1e-7, gfirst == 0
    assert firm.mean() > 0.1 and (firm | untouched).mean() > 0.9
    np.testing.assert_allclose(vol[firm], params["volume"][firm], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(vol, params["volume"], rtol=0, atol=3 * 5e-4)
    np.testing.assert_array_equal(vol[untouched], case["volume"][untouched])
    assert np.abs(vol - case["volume"]).max() > 1e-4
    for k, v in system.mvsnet.state_dict().items():
        assert torch.equal(v, runs["mvs_before"][k]), k


def test_snapshot_round_trip_resumes(case, tmp_path):
    from mvsnerf_tpu_torch.io.checkpoint import latest_checkpoint
    a = _port_system(case)
    a.fit(num_steps=2, ckpt_dir=str(tmp_path), val_every=0)
    assert latest_checkpoint(str(tmp_path))[0] == 2
    b = _port_system(case)
    assert b.restore(str(tmp_path)) == 2
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys() and sa["state"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert a.scheduler.last_epoch == b.scheduler.last_epoch == 2
    batch = case["batches"][2]
    assert _port_step(a, batch) == _port_step(b, batch)
    assert torch.equal(a.volume, b.volume)
    for pa, pb in zip(a.mlp.parameters(), b.mlp.parameters()):
        assert torch.equal(pa, pb)
    assert b.restore(str(tmp_path / "none")) == 0
    with pytest.raises(FileNotFoundError):
        b.restore(str(tmp_path / "none"), strict=True)


def test_snapshots_are_atomic_and_pruned(tmp_path):
    from mvsnerf_tpu_torch.io.checkpoint import latest_checkpoint, \
        load_checkpoint, save_checkpoint
    for step in range(1, 6):
        save_checkpoint(str(tmp_path), {"global_step": step,
                                        "x": torch.full((3,), step)}, step)
    assert sorted(os.listdir(tmp_path)) == [
        f"ckpt_{s:09d}.pt" for s in (3, 4, 5)]
    step, path = latest_checkpoint(str(tmp_path))
    assert step == 5 and load_checkpoint(path)["global_step"] == 5


@pytest.mark.parametrize("scheduler,warmup", [
    ("steplr", 0), ("cosine", 0), ("poly", 0), ("steplr", 300),
    ("cosine", 300)])
def test_lr_schedule_matches_optax(scheduler, warmup):
    from mvsnerf_tpu.utils.schedulers import make_lr_schedule as jax_sched
    from mvsnerf_tpu_torch.utils.schedulers import make_lr_schedule
    kw = dict(decay_step=(5000, 8000, 9000), decay_gamma=0.5,
              num_steps=10000, warmup_steps=warmup)
    ours = make_lr_schedule(5e-4, scheduler, **kw)
    ref = jax_sched(5e-4, scheduler, **kw)
    for count in (0, 1, 299, 300, 301, 4999, 5000, 5001, 8000, 9000, 9999,
                  10000, 12000):
        # optax evaluates in float32
        np.testing.assert_allclose(ours(count), float(ref(count)),
                                   rtol=1e-5, atol=1e-9, err_msg=count)
    if scheduler == "steplr" and not warmup:
        assert ours(4999) == 5e-4 and ours(5000) == ours(5001) == 2.5e-4


def test_lr_schedule_drives_lambda_lr_like_optax_count():
    """Update k runs at schedule(k), as optax's count does."""
    from mvsnerf_tpu_torch.utils.schedulers import make_lr_schedule
    sched = make_lr_schedule(1e-2, "steplr", decay_step=(3, 5))
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=1e-2)
    lr_sched = torch.optim.lr_scheduler.LambdaLR(opt,
                                                 lambda s: sched(s) / 1e-2)
    for k in range(8):
        assert opt.param_groups[0]["lr"] == pytest.approx(sched(k))
        opt.step()
        lr_sched.step()


def test_ray_batch_iterator_matches_jax():
    from mvsnerf_tpu.train.common import RayBatchIterator as JaxIterator
    from mvsnerf_tpu_torch.train.common import RayBatchIterator
    rng = np.random.default_rng(4)
    arrays = {"rays": rng.standard_normal((1000, 8)).astype(np.float32),
              "rgbs": rng.uniform(0, 1, (1000, 3)).astype(np.float32)}
    ours, ref = RayBatchIterator(arrays, 300, seed=7), \
        JaxIterator(arrays, 300, seed=7)
    for _ in range(7):  # wraps into the next epoch's permutation twice
        a, b = next(ours), next(ref)
        for k in arrays:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def test_prefetcher_stops_its_thread():
    from mvsnerf_tpu_torch.train.common import Prefetcher, RayBatchIterator
    pf = Prefetcher(RayBatchIterator({"x": np.arange(10)}, 4, seed=0))
    assert len(next(pf)["x"]) == 4
    pf.close()
    assert not pf._thread.is_alive()


def test_reference_checkpoint_volume_loads(case, tmp_path):
    from mvsnerf_tpu_torch.io.torch_ckpt import load_reference_checkpoint, \
        volume_from_jax
    _, _, volume = load_reference_checkpoint(case["ckpt"])
    np.testing.assert_array_equal(volume.numpy(), case["volume"])
    assert volume.is_contiguous()
    np.testing.assert_array_equal(volume_from_jax(case["volume"]).numpy(),
                                  case["volume"])


@pytest.mark.parametrize("extra", ["--net_type v1 --use_density_volume"])
def test_unported_options_are_refused(case, extra):
    """The density refresh needs an alpha head, which v1 lacks."""
    with pytest.raises(NotImplementedError, match="no alpha head|has none"):
        _port_system(case, extra)


def test_v2_step_matches_jax(case, tmp_path):
    """`--net_type v2` (which v0's refusal used to stop): one step on the
    module's MLP (K7 takes v0 alone) from a v2 reference checkpoint,
    against JAX's XLA route at the same weights, volume and batch: loss
    rel <= 1e-5, gradients abs <= 1e-4 x max|g|."""
    from mvsnerf_tpu.io.torch_ckpt import export_reference_checkpoint
    from mvsnerf_tpu_torch.io.torch_ckpt import state_dicts_from_jax
    from torch_port_common import jax_mlp_params
    mlp_p = jax_mlp_params("v2", 3)
    ckpt = str(tmp_path / "v2.tar")
    export_reference_checkpoint(ckpt, mlp_p, case["mvs"],
                                volume=case["volume"])
    port = _port_system(dict(case, ckpt=ckpt), "--net_type v2")
    assert port.mlp.net_type == "v2" and not port.mlp.runs_v0_kernels
    step, params, opt_state = _jax_stepper(case, "v2", mlp_p)
    b = case["batches"][0]
    _, _, loss, grads = step(params, opt_state, jnp.asarray(b["rays"]),
                             jnp.asarray(b["rgbs"]))
    ours = _port_step(port, b)
    assert abs(ours - float(loss)) <= 1e-5 * abs(float(loss))
    gv = np.asarray(grads["volume"])
    assert np.abs(gv).max() > 0
    np.testing.assert_allclose(port.volume.grad.numpy(), gv, rtol=0,
                               atol=1e-4 * np.abs(gv).max())
    ref_sd = state_dicts_from_jax(jax.tree.map(np.asarray, grads["mlp"]),
                                  None, "v2")[0]
    for name, p in port.mlp.named_parameters():
        g = ref_sd[name]
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=0,
                                   atol=1e-4 * g.abs().max().item(),
                                   err_msg=name)


@pytest.mark.parametrize("check", ["construction", "strict restore"])
def test_msgpack_snapshots_are_refused(case, tmp_path, check):
    """A `.msgpack` `--ckpt` is a JAX snapshot, not a reference checkpoint:
    construction skips it and builds the seeded modules, as JAX
    finetune.py:66-70 does; restoring an empty one raises ValueError
    naming the file."""
    from mvsnerf_tpu_torch.train.finetune import FinetuneSystem, \
        seeded_modules
    path = tmp_path / "ckpt_000000001.msgpack"
    path.write_bytes(b"")
    args = _port_args(str(path))
    system = FinetuneSystem(args, case["scene"], device="cpu")
    if check == "construction":
        mlp, mvsnet = seeded_modules(args, torch.device("cpu"))
        for ours, ref in ((system.mlp, mlp), (system.mvsnet, mvsnet)):
            for k, v in ref.state_dict().items():
                torch.testing.assert_close(ours.state_dict()[k], v,
                                           rtol=0, atol=0, msg=k)
    else:
        with pytest.raises(ValueError, match=re.escape(str(path))):
            system.restore(str(path), strict=True)


def test_config_matches_jax_flags_and_names_tpu_switches(capsys):
    from mvsnerf_tpu.config import config_parser as jax_parser
    from mvsnerf_tpu_torch.config import TPU_ONLY, config_parser
    cmd = ("--dataset_name dtu_ft --with_rgb_loss --pad 4 --decay_step 10 "
           "20 --mlp_impl pallas --volume_gather_impl pallas2 --N_samples 64")
    ours, ref = vars(config_parser(cmd)), vars(jax_parser(cmd))
    # the port's own flag: the card unless the command line says cpu
    assert ours.pop("device") == "cuda"
    assert ours == ref
    out = capsys.readouterr().out
    assert "--mlp_impl pallas" in out and "--volume_gather_impl" in out
    assert "--warp_mode" not in out
    assert set(TPU_ONLY) <= set(ours)

"""The port's generalizable trainer against the JAX package, on the CPU, on a
tiny in-memory scene (4 views of 32x32, the target last; pad 4, 128
planes, 16 samples, 256 rays, depth loss).

The JAX reference step composes mvsnerf_tpu/train/generalizable.py:100-170
from JAX pieces with the same injected pixels and depth jitter:
`mvsnet_apply(warp_mode="packed", costreg_impl="plain",
featurenet_impl="plain")`, then `render_rays(fast_volume_grad=False,
mlp_impl="xla")` (JAX autodiff of the exact gather, not the banded VJP
that JAX's own step resolves to off the TPU, which can drop taps), plus
`optax.adam` on the cosine schedule (at LRATE, see there). The JAX
weights reach the port
through a reference-format checkpoint (`--ckpt`). Each step keeps the
first BATCH of POOL drawn rays whose samples all lie more than KINK from
every ReLU kink of the MLP (float64, `relu_margin`): float32 rounding may
put such a sample on either side, and its gradient then differs by design.
Nothing is left out at MVSNet's LeakyReLU kinks. Tolerances: loss rel <=
1e-5; the gradients of each part (the MLP, CostRegNet, FeatureNet) abs <=
1e-4 x the part's max|g|.

Also here: smooth_l1 and the cosine schedule against JAX's, snapshots and
a restore before the first step, the DTU loader against JAX's on a
scripts/make_synthetic_scene.py tree and its CLI, the copied pair and
scan lists, and the device policy of every entry point.
"""

import filecmp
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from torch_port_common import jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 32
PAD, N_SAMPLES, BATCH, POOL, STEPS = 4, 16, 256, 1024, 3
KINK = 5e-6
# Adam's first updates are lr x g / (|g| + eps) element by element: where
# |g| lies at the float32 noise of a gradient, the two runs' updates differ
# by up to 2 lr. At the default lr 5e-4 the MVSNet weights moved so take
# the third step's loss ~5e-5 apart (relative); at 5e-5, ~5e-7.
LRATE = 5e-5
# the trained parts; gradients are held to 1e-4 x the part's max|g|
PARTS = ("mlp.", "mvsnet.cost_reg_2.", "mvsnet.feature.")


def _sample(seed=9, n_views=4):
    """A generalizable batch (the shape of MVSDatasetDTU's samples): views
    on an arc around the scene, the target last, GT depths with holes
    (tests/torch_parallel_ranks.py's, which the JAX-free ranks share)."""
    from torch_parallel_ranks import generalizable_sample
    return generalizable_sample(seed, n_views, H)


def _port_args(ckpt=None, extra=""):
    from mvsnerf_tpu_torch.config import config_parser
    return config_parser(
        f"--dataset_name dtu --pad {PAD} --N_samples {N_SAMPLES} "
        f"--batch_size {BATCH} --with_depth_loss --with_depth --net_type v0 "
        + (f"--ckpt {ckpt} " if ckpt else "") + extra)


def _port_system(ckpt=None, extra=""):
    from mvsnerf_tpu_torch.train.generalizable import GeneralizableSystem
    return GeneralizableSystem(_port_args(ckpt, extra), device="cpu")


def _jax_stepper(lrate):
    """The JAX reference step (jitted): generalizable.py:100-170 with the
    draws passed in, then Adam on the cosine schedule."""
    from mvsnerf_tpu.models import mvsnet_apply
    from mvsnerf_tpu.ops.geometry import get_ndc_coordinate, \
        rays_from_pixels
    from mvsnerf_tpu.render.renderer import render_rays
    from mvsnerf_tpu.train.common import unpreprocess_images
    from mvsnerf_tpu.train.generalizable import smooth_l1
    from mvsnerf_tpu.utils.schedulers import make_lr_schedule

    def loss_fn(params, batch, xs, ys, u):
        near_fars, w2cs = batch["near_fars"], batch["w2cs"]
        intrinsics = batch["intrinsics"]
        volume = mvsnet_apply(
            params["mvsnet"], batch["images"][:3], batch["proj_mats"][:3],
            near_fars[0], pad=PAD, warp_mode="packed", costreg_impl="plain",
            featurenet_impl="plain")[0]
        imgs = unpreprocess_images(batch["images"])
        tgt = imgs.shape[0] - 1
        rays_o, rays_d = rays_from_pixels(xs, ys, intrinsics[tgt],
                                          batch["c2ws"][tgt])
        xi, yi = xs.astype(jnp.int32), ys.astype(jnp.int32)
        target_rgb = imgs[tgt, yi, xi]
        target_depth = batch["depths_h"][tgt, yi, xi]
        t = jnp.linspace(0.0, 1.0, N_SAMPLES)
        z = near_fars[tgt, 0] * (1 - t) + near_fars[tgt, 1] * t
        z_vals = jnp.broadcast_to(z, u.shape)
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = jnp.concatenate([mids, z_vals[..., -1:]], -1)
        lower = jnp.concatenate([z_vals[..., :1], mids], -1)
        z_vals = lower + (upper - lower) * u
        pts = jnp.broadcast_to(rays_o, (len(xs), 3))[:, None] + \
            z_vals[..., None] * rays_d[:, None]
        pts_ndc = get_ndc_coordinate(
            w2cs[0], intrinsics[0], pts, jnp.asarray([W - 1.0, H - 1.0]),
            near=near_fars[0, 0], far=near_fars[0, 1], pad=PAD)
        out = render_rays(
            params["mlp"], volume, pts, pts_ndc, z_vals, rays_d,
            w2c_ref=w2cs[0], w2cs=w2cs[:3], intrinsics=intrinsics[:3],
            imgs=imgs[:3], fast_volume_grad=False, mlp_impl="xla")
        img_loss = jnp.mean((out["rgb"] - target_rgb) ** 2)
        mask = target_depth > 0
        dl = smooth_l1(out["depth"], target_depth) * 0.5
        return img_loss + jnp.sum(jnp.where(mask, dl, 0.0)) / \
            jnp.maximum(jnp.sum(mask), 1)

    opt = optax.adam(make_lr_schedule(lrate, "cosine", num_steps=STEPS,
                                      eta_min=1e-7), b1=0.9, b2=0.999)

    @jax.jit
    def step(params, opt_state, batch, xs, ys, u):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch, xs, ys, u)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    return step, opt


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    from mvsnerf_tpu.io.torch_ckpt import export_reference_checkpoint
    mlp_p, mvs_p = jax_params(0)
    ckpt = str(tmp_path_factory.mktemp("ck") / "ref.tar")
    export_reference_checkpoint(ckpt, mlp_p, mvs_p)
    return dict(sample=_sample(), mlp=mlp_p, mvs=mvs_p, ckpt=ckpt)


@pytest.fixture(scope="module")
def runs(case):
    """STEPS steps of the port and of JAX from the same weights on the
    same kink-clear draws; the gradients of every step."""
    from mvsnerf_tpu_torch.ops.mlp_train import relu_margin
    port = _port_system(case["ckpt"], f"--lrate {LRATE}")
    port.schedule_steps = STEPS
    batch = port.batch(case["sample"])
    jbatch = {k: jnp.asarray(case["sample"][k]) for k in batch}
    step, opt = _jax_stepper(port.args.lrate)
    params = jax.tree.map(jnp.asarray, {"mlp": case["mlp"],
                                        "mvsnet": case["mvs"]})
    opt_state = opt.init(params)
    rng = np.random.default_rng(3)
    out = {"port_loss": [], "jax_loss": [], "port_grads": [],
           "jax_grads": []}
    for _ in range(STEPS):
        xs = rng.integers(0, W, POOL).astype(np.float32)
        ys = rng.integers(0, H, POOL).astype(np.float32)
        u = rng.uniform(size=(POOL, N_SAMPLES)).astype(np.float32)
        draws = [torch.from_numpy(a) for a in (xs, ys, u)]
        margin = relu_margin(port.mlp, port.mlp_input(batch, *draws))
        keep = np.flatnonzero(
            (margin.reshape(POOL, -1).amin(1) > KINK).numpy())[:BATCH]
        assert len(keep) == BATCH
        params, opt_state, loss, grads = step(
            params, opt_state, jbatch, *(jnp.asarray(a[keep])
                                         for a in (xs, ys, u)))
        out["jax_loss"].append(float(loss))
        out["jax_grads"].append(jax.tree.map(np.asarray, grads))
        out["port_loss"].append(float(port._step(
            batch, *(d[keep] for d in draws))[0]))
        out["port_grads"].append(
            {f"{m}.{n}": p.grad.clone() for m, mod in
             (("mlp", port.mlp), ("mvsnet", port.mvsnet))
             for n, p in mod.named_parameters()})
    return out


def _check_grads(ours, grads):
    from mvsnerf_tpu_torch.io.torch_ckpt import state_dicts_from_jax
    fn_sd, mvs_sd = state_dicts_from_jax(grads["mlp"], grads["mvsnet"])
    ref = {**{f"mlp.{k}": v for k, v in fn_sd.items()},
           **{f"mvsnet.{k}": v for k, v in mvs_sd.items()}}
    for part in PARTS:
        names = [n for n in ours if n.startswith(part)]
        g_max = max(float(ref[n].abs().max()) for n in names)
        # the step trains every part: FeatureNet's gradient comes through
        # the sweep's backward
        assert g_max > 0, part
        for name in names:
            np.testing.assert_allclose(ours[name].numpy(), ref[name].numpy(),
                                       rtol=0, atol=1e-4 * g_max,
                                       err_msg=name)


def test_generalizable_one_step_matches_jax(runs):
    loss, ref = runs["port_loss"][0], runs["jax_loss"][0]
    assert abs(loss - ref) <= 1e-5 * abs(ref)
    _check_grads(runs["port_grads"][0], runs["jax_grads"][0])


def test_generalizable_three_steps_match_jax(runs):
    for loss, ref in zip(runs["port_loss"], runs["jax_loss"]):
        assert abs(loss - ref) <= 1e-5 * abs(ref)
    assert len(set(runs["jax_loss"])) == STEPS
    _check_grads(runs["port_grads"][-1], runs["jax_grads"][-1])


def test_smooth_l1_matches_jax():
    from mvsnerf_tpu.train.generalizable import smooth_l1 as jax_smooth_l1
    from mvsnerf_tpu_torch.train.generalizable import smooth_l1
    rng = np.random.default_rng(1)
    pred, target = rng.normal(0, 2, (2, 1000)).astype(np.float32)
    for beta in (1.0, 0.5):
        np.testing.assert_allclose(
            smooth_l1(torch.from_numpy(pred), torch.from_numpy(target),
                      beta).numpy(),
            np.asarray(jax_smooth_l1(jnp.asarray(pred), jnp.asarray(target),
                                     beta)), rtol=1e-6, atol=1e-7)


def test_cosine_schedule_matches_optax():
    """The trainer's learning rate at update k is JAX's cosine schedule
    (eta_min 1e-7 over the run's steps), evaluated by optax in float32."""
    from mvsnerf_tpu.utils.schedulers import make_lr_schedule
    system = _port_system()
    system.schedule_steps = 10
    ref = make_lr_schedule(system.args.lrate, "cosine", num_steps=10,
                           eta_min=1e-7)
    for count in (0, 1, 4, 9, 10, 15):
        np.testing.assert_allclose(system._lr(count), float(ref(count)),
                                   rtol=1e-5, atol=1e-11, err_msg=count)
    assert system.optimizer.param_groups[0]["lr"] == system.args.lrate


def test_generalizable_restore_before_step(tmp_path):
    """tests/test_train.py's kill + resume into a fresh system: a restore
    before any step, then training goes on from the snapshot."""
    ds = [_sample(seed) for seed in (1, 2)]
    system = _port_system(extra="--N_samples 8 --batch_size 64")
    system.fit(ds, num_epochs=1, max_steps=2, ckpt_dir=str(tmp_path),
               ckpt_every=1)
    fresh = _port_system(extra="--N_samples 8 --batch_size 64")
    assert fresh.restore(str(tmp_path)) == 2
    for a, b in zip(system.mvsnet.parameters(), fresh.mvsnet.parameters()):
        assert torch.equal(a, b)
    assert fresh.scheduler.last_epoch == 2
    losses = fresh.fit(ds, num_epochs=2, max_steps=4)
    assert fresh.global_step == 4 and len(losses) == 2
    assert all(np.isfinite(losses))


def test_render_view_shapes(case, monkeypatch):
    from mvsnerf_tpu_torch.render import renderer
    k8 = []
    fused = renderer.render_v0_feats
    monkeypatch.setattr(renderer, "render_v0_feats",
                        lambda *a: k8.append(1) or fused(*a))
    system = _port_system(case["ckpt"], "--N_samples 8")
    out = system.render_view(case["sample"], chunk=300)
    assert k8  # the validation render composites through K8's wrapper
    assert out["rgb"].shape == (H, W, 3) and out["depth"].shape == (H, W)
    assert np.isfinite(out["rgb"]).all()
    np.testing.assert_allclose(
        out["target"], case["sample"]["images"][-1] *
        np.float32([0.229, 0.224, 0.225]) +
        np.float32([0.485, 0.456, 0.406]), rtol=0, atol=1e-6)


# ---------------------------------------------------------------- data ---

@pytest.fixture(scope="module")
def dtu_tree(tmp_path_factory):
    """scripts/make_synthetic_scene.py's tree of one scan."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        from make_synthetic_scene import make_multiscan
    finally:
        sys.path.pop(0)
    root = str(tmp_path_factory.mktemp("dtu_synth"))
    make_multiscan(root, ["scan3"])
    return root


@pytest.mark.parametrize("split,down", [("train", 1.0), ("val", 0.5)])
def test_dtu_sample_matches_jax(dtu_tree, monkeypatch, split, down):
    """Both loaders' sample dicts, key by key; the JAX loader on its numpy
    depth route (its native library is the JAX package's own)."""
    from mvsnerf_tpu import native
    from mvsnerf_tpu.data.dtu import MVSDatasetDTU as JaxDTU
    from mvsnerf_tpu_torch.data.dtu import MVSDatasetDTU
    monkeypatch.setattr(native, "available", lambda: False)
    kw = dict(downSample=down, scan_list=["scan3"], max_len=4)
    ours, ref = MVSDatasetDTU(dtu_tree, split, **kw), \
        JaxDTU(dtu_tree, split, **kw)
    assert len(ours) == len(ref) == 4
    for idx in (0, 3):
        a, b = ours[idx], ref[idx]
        assert a.keys() == b.keys()
        for k in a:
            if k == "scan":
                assert a[k] == b[k]
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["depths_h"].shape[1:] == (int(512 * down), int(640 * down))
        assert (a["depths_h"] > 0).all()


def test_copied_pair_and_scan_lists_are_byte_equal():
    ours = os.path.join(ROOT, "mvsnerf_tpu_torch", "configs")
    ref = os.path.join(ROOT, "mvsnerf_tpu", "configs")
    names = ["dtu_pairs.txt"] + [os.path.join("lists", n) for n in
                                 sorted(os.listdir(os.path.join(ref,
                                                                "lists")))]
    assert len(names) == 4
    for name in names:
        assert filecmp.cmp(os.path.join(ours, name), os.path.join(ref, name),
                           shallow=False), name


def test_train_mvs_nerf_cli_writes_and_resumes(dtu_tree, tmp_path,
                                               monkeypatch, capsys):
    """`python -m mvsnerf_tpu_torch.train_mvs_nerf --device cpu` on the
    tree: trains, writes metrics.csv with a val PSNR and a snapshot, and a
    second run resumes from it."""
    from mvsnerf_tpu_torch.train_mvs_nerf import main
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset_name", "dtu", "--datadir", dtu_tree, "--scan_list",
            os.path.join(dtu_tree, "scans.txt"), "--expname", "cli",
            "--imgScale_train", "0.25", "--imgScale_test", "0.25", "--pad",
            "4", "--N_samples", "8", "--batch_size", "64", "--N_vis", "1",
            "--with_depth_loss", "--device", "cpu", "--max_steps"]
    main(argv + ["2"])
    run = tmp_path / "runs_new/cli"
    assert sorted(os.listdir(run / "ckpts")) == ["ckpt_000000002.pt"]
    rows = (run / "metrics.csv").read_text().splitlines()
    assert "val/PSNR" in rows[0].split(",") and len(rows) == 2
    main(argv + ["3"])
    assert "resumed from runs_new/cli/ckpts at step 2" in \
        capsys.readouterr().out
    assert "ckpt_000000003.pt" in os.listdir(run / "ckpts")
    # more ranks than cards raises, naming both counts; no quiet drop to
    # one rank and no quiet move to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    card = [a for a in argv if a not in ("--device", "cpu")]
    with pytest.raises(ValueError, match="2 ranks, one a card, but torch "
                                         "sees 1 card"):
        main(card + ["3", "--num_devices", "2"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="WORLD_SIZE 2"):
        main(argv + ["3", "--num_devices", "3"])


def test_train_mvs_nerf_cli_two_ranks_on_cpu(dtu_tree, tmp_path,
                                             monkeypatch, capfd):
    """`--num_devices 2 --device cpu` spawns 2 gloo ranks: rank 0 alone
    writes metrics.csv (train and val rows) and the snapshots, and a
    second run resumes both ranks from the same snapshot."""
    from mvsnerf_tpu_torch.train_mvs_nerf import main
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = ["--dataset_name", "dtu", "--datadir", dtu_tree, "--scan_list",
            os.path.join(dtu_tree, "scans.txt"), "--expname", "dp",
            "--imgScale_train", "0.25", "--imgScale_test", "0.25", "--pad",
            "4", "--N_samples", "8", "--batch_size", "64", "--N_vis", "1",
            "--with_depth_loss", "--device", "cpu", "--num_devices", "2",
            "--ckpt_every", "1", "--max_steps"]
    main(argv + ["2"])
    run = tmp_path / "runs_new/dp"
    assert sorted(os.listdir(run / "ckpts")) == ["ckpt_000000001.pt",
                                                 "ckpt_000000002.pt"]
    # rank 0 alone writes the CSV, the validation panel and, where
    # tensorboardX imports, the TensorBoard events
    assert sorted(n for n in os.listdir(run)
                  if not n.startswith("events.out.tfevents")) == \
        ["ckpts", "metrics.csv", "val_00_00000002.png"]
    rows = (run / "metrics.csv").read_text().splitlines()
    assert "val/PSNR" in rows[0].split(",") and len(rows) == 2
    capfd.readouterr()
    main(argv + ["3"])
    out = capfd.readouterr().out
    assert out.count("resumed from runs_new/dp/ckpts at step 2") == 1
    assert "1 steps on cpu x 2 ranks" in out
    assert "ckpt_000000003.pt" in os.listdir(run / "ckpts")
    rows = (run / "metrics.csv").read_text().splitlines()
    assert rows[-1].split(",")[0] == "3"


# -------------------------------------------------------------- device ---

def test_entry_points_need_a_card_unless_asked_for_the_cpu(case, dtu_tree,
                                                           monkeypatch):
    """With no CUDA device, every entry point raises unless the caller
    names the CPU; none falls back to it on its own."""
    from mvsnerf_tpu_torch import resolve_device
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator
    from mvsnerf_tpu_torch.models.mvsnet import MVSNet
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.train.finetune import FinetuneSystem
    from mvsnerf_tpu_torch.train.generalizable import GeneralizableSystem
    from mvsnerf_tpu_torch.train_finetune import main as finetune_main
    from mvsnerf_tpu_torch.train_mvs_nerf import main as generalizable_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _port_args(case["ckpt"])
    entries = [
        lambda: Evaluator(MVSNet(), MVSNeRF()),
        lambda: FinetuneSystem(args, None),
        lambda: GeneralizableSystem(args),
        lambda: finetune_main(["--dataset_name", "dtu_ft", "--datadir",
                               os.path.join(dtu_tree, "scan3")]),
        lambda: generalizable_main(["--dataset_name", "dtu", "--datadir",
                                    dtu_tree])]
    for entry in entries:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    assert resolve_device("cpu") == torch.device("cpu")
    assert GeneralizableSystem(args, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")

"""The port's fine-tune trainer with `--use_color_volume` against the JAX
package, on the CPU, on test_torch_finetune.py's tiny scene (5 views of
32x32, pad 4, a (128, 16, 16, 8) seeded volume baked to 20 channels, 16
samples, batches of 256 rays, perturb 0).

The JAX reference step differentiates `render_rays(use_color_volume=True,
fast_volume_grad=False, mlp_impl="xla")`: autodiff of the exact
`index_point_feature`, not the banded VJP that JAX's own trainer resolves
to at C=20 off the TPU (which may drop taps). Both start from JAX's baked
volume, through a reference-format checkpoint that holds it. Tolerances
as test_torch_finetune.py's: loss rel <= 1e-5; gradients abs <= 1e-4 x
max|g|; parameters after 3 steps abs <= 1e-5 (volume values whose first
gradient is eps-sized: Adam's bound). Also here: the trainer's own bake,
Adam without the MVSNet, snapshots and resume, `render_video`'s frames in
the `tiled` mode, and the fine-tune CLI trained and resumed on the
synthetic scene.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_finetune import BATCH, KEPT, KINK, N_SAMPLES, NEAR_FAR, \
    PAD, Scene, _port_args
from torch_port_common import jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 32


class VideoScene(Scene):
    def load_poses_all(self):
        return np.linalg.inv(self.w2cs)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """JAX weights, a seeded 8-channel volume, JAX's bake of it, reference
    checkpoints holding each, and 3 batches from the JAX iterator."""
    from mvsnerf_tpu.io.torch_ckpt import export_reference_checkpoint
    from mvsnerf_tpu.render.tiled import bake_color_volume
    from mvsnerf_tpu.train.common import RayBatchIterator, \
        unpreprocess_images
    scene = VideoScene()
    mlp_p, mvs_p = jax_params(1)
    imgs_norm, _, nf, pose = scene.read_source_views()
    rng = np.random.default_rng(2)
    volume8 = (rng.standard_normal((128, H // 4 + 2 * PAD,
                                    W // 4 + 2 * PAD, 8)) * 0.5).astype(
        np.float32)
    vol20 = np.asarray(bake_color_volume(
        jnp.asarray(volume8), unpreprocess_images(jnp.asarray(imgs_norm)),
        {k: jnp.asarray(v) for k, v in pose.items()},
        np.asarray(nf, np.float32), PAD))
    ck = tmp_path_factory.mktemp("ck")
    ckpt8, ckpt20 = str(ck / "vol8.tar"), str(ck / "vol20.tar")
    export_reference_checkpoint(ckpt8, mlp_p, mvs_p, volume=volume8)
    export_reference_checkpoint(ckpt20, mlp_p, mvs_p, volume=vol20)
    it = RayBatchIterator({"rays": scene.all_rays, "rgbs": scene.all_rgbs},
                          BATCH, seed=1)
    return dict(scene=scene, mlp=mlp_p, mvs=mvs_p, volume8=volume8,
                vol20=vol20, ckpt8=ckpt8, ckpt20=ckpt20,
                batches=[next(it) for _ in range(3)])


def _system(case, ckpt, extra=""):
    from mvsnerf_tpu_torch.train.finetune import FinetuneSystem
    return FinetuneSystem(_port_args(ckpt, "--use_color_volume " + extra),
                          case["scene"], device="cpu")


def test_color_volume_bake_and_optimizer(case):
    system = _system(case, case["ckpt8"])
    vol = system.volume.detach().numpy()
    assert vol.shape == (128, 16, 16, 20)
    np.testing.assert_array_equal(vol[..., :8], case["volume8"])
    # colours and masks as JAX bakes them; a voxel on a view's border may
    # flip its mask by an ulp
    assert (np.abs(vol - case["vol20"]) > 1e-5).mean() < 1e-3
    # Adam over {mlp, volume}: no MVSNet parameter (finetune.py:133-136)
    held = {id(p) for g in system.optimizer.param_groups for p in g["params"]}
    assert not held & {id(p) for p in system.mvsnet.parameters()}
    assert held == {id(system.volume)} | {id(p)
                                          for p in system.mlp.parameters()}
    # a checkpoint that holds the baked volume is taken as it is
    np.testing.assert_array_equal(
        _system(case, case["ckpt20"]).volume.detach().numpy(), case["vol20"])


def _jax_stepper(case):
    from mvsnerf_tpu.ops.geometry import get_ndc_coordinate
    from mvsnerf_tpu.ops.sampling import ray_marcher
    from mvsnerf_tpu.render.renderer import render_rays
    from mvsnerf_tpu.utils.schedulers import make_lr_schedule
    _, _, nf, pose = case["scene"].read_source_views()
    w2cs, intrs = jnp.asarray(pose["w2cs"]), jnp.asarray(pose["intrinsics"])
    near_far = jnp.asarray(nf, jnp.float32)

    def loss_fn(params, rays, rgbs):
        pts, _, rays_d, z = ray_marcher(jax.random.PRNGKey(0), rays,
                                        N_SAMPLES, perturb=0.0)
        ndc = get_ndc_coordinate(w2cs[0], intrs[0], pts,
                                 jnp.asarray([W - 1.0, H - 1.0]),
                                 near=near_far[0], far=near_far[1], pad=PAD)
        out = render_rays(params["mlp"], params["volume"], pts, ndc, z,
                          rays_d, w2c_ref=w2cs[0], use_color_volume=True,
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

    params = {"mlp": case["mlp"], "volume": jnp.asarray(case["vol20"])}
    return step, params, opt.init(params)


@pytest.fixture(scope="module")
def runs(case):
    """3 steps of the port and of JAX on the same batches, each batch cut
    to its first KEPT rays clear of every ReLU kink (test_torch_finetune's
    rule)."""
    from mvsnerf_tpu_torch.ops.mlp_train import relu_margin
    port = _system(case, case["ckpt20"])
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
        out["port_loss"].append(float(port._step(
            torch.from_numpy(batch["rays"]), torch.from_numpy(batch["rgbs"]))))
        g = np.abs(np.asarray(grads["volume"]))
        first = out.get("vol_gfirst", np.zeros_like(g))
        out["vol_gfirst"] = np.where(first == 0, g, first)
        if "jax_grads" not in out:
            out["jax_grads"] = jax.tree.map(np.asarray, grads)
            out["port_grads"] = {
                "volume": port.volume.grad.clone(),
                **{n: p.grad.clone() for n, p in port.mlp.named_parameters()}}
    out["jax_params"] = jax.tree.map(np.asarray, params)
    out["port"] = port
    return out


def test_color_volume_one_step_matches_jax(case, runs):
    from mvsnerf_tpu_torch.io.torch_ckpt import state_dicts_from_jax
    loss, ref = runs["port_loss"][0], runs["jax_loss"][0]
    assert abs(loss - ref) <= 1e-5 * abs(ref)
    gv = runs["jax_grads"]["volume"]
    assert gv.shape[-1] == 20 and np.abs(gv[..., 8:]).max() > 0
    np.testing.assert_allclose(runs["port_grads"]["volume"].numpy(), gv,
                               rtol=0, atol=1e-4 * np.abs(gv).max())
    ref_sd = state_dicts_from_jax(runs["jax_grads"]["mlp"], case["mvs"])[0]
    for name, g in ref_sd.items():
        np.testing.assert_allclose(runs["port_grads"][name].numpy(),
                                   g.numpy(), rtol=0,
                                   atol=1e-4 * g.abs().max().item(),
                                   err_msg=name)


def test_color_volume_three_steps_match_jax(case, runs):
    from mvsnerf_tpu_torch.io.torch_ckpt import state_dicts_from_jax
    for loss, ref in zip(runs["port_loss"], runs["jax_loss"]):
        assert abs(loss - ref) <= 1e-5 * abs(ref)
    assert len(set(runs["jax_loss"])) == 3
    system, params = runs["port"], runs["jax_params"]
    ref_sd = state_dicts_from_jax(params["mlp"], case["mvs"])[0]
    for name, p in system.mlp.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref_sd[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    vol = system.volume.detach().numpy()
    gfirst = runs["vol_gfirst"]
    firm, untouched = gfirst > 1e-7, gfirst == 0
    assert firm.mean() > 0.1 and (firm | untouched).mean() > 0.9
    np.testing.assert_allclose(vol[firm], params["volume"][firm], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(vol, params["volume"], rtol=0, atol=3 * 5e-4)
    np.testing.assert_array_equal(vol[untouched], case["vol20"][untouched])


def test_color_volume_snapshot_resumes(case, tmp_path):
    a = _system(case, case["ckpt20"])
    a.fit(num_steps=2, ckpt_dir=str(tmp_path), val_every=0)
    b = _system(case, case["ckpt20"])
    assert b.restore(str(tmp_path)) == 2
    assert torch.equal(a.volume, b.volume)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    batch = case["batches"][2]
    rays, rgbs = (torch.from_numpy(batch[k]) for k in ("rays", "rgbs"))
    assert float(a._step(rays, rgbs)) == float(b._step(rays, rgbs))


def test_render_video_frames_tiled(case, tmp_path):
    """render_video through render_image in the `tiled` mode: the frames
    of the colour volume through K6b's twin equal those of the chunked
    path (K5's and K8's twins, unjittered at perturb 0) to one level."""
    from mvsnerf_tpu_torch.eval.video import make_path, render_video
    tiled = _system(case, case["ckpt20"], "--render_mode tiled")
    chunked = _system(case, case["ckpt20"])
    poses = make_path("interp", dataset=case["scene"], n_frames=3)
    assert len(poses) == 4  # 4 key poses x (3 // 3)
    out = str(tmp_path / "video.mp4")
    frames = render_video(tiled, poses[:2], H, W, [40.0, 40.0], NEAR_FAR,
                          out, chunk=512, with_depth_panel=True)
    assert len(frames) == 2 and frames[0].shape == (H, 2 * W, 3)
    assert frames[0].dtype == np.uint8 and frames[0].std() > 1
    written = render_video.last_path
    assert os.path.exists(written) and os.path.getsize(written) > 0
    again = render_video(chunked, poses[:2], H, W, [40.0, 40.0], NEAR_FAR,
                         chunk=512)
    assert len(again) == 2
    for f, g in zip(frames, again):
        assert np.abs(f[:, :W].astype(int) - g.astype(int)).max() <= 1
    assert tiled._tiled_cache[2].volume.shape[-1] == 20


@pytest.mark.parametrize("mode", ["tiled", "chunked"])
def test_render_image_follows_render_mode(case, mode, monkeypatch):
    """`render_image` picks its renderer from `--render_mode` alone: tiled
    calls K6b's wrapper and never K8's; chunked calls K8's (gradients are
    off) and never K6b's."""
    from mvsnerf_tpu_torch.render import renderer, tiled
    calls = {"K6b": 0, "K8": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tiled, "render_v0", spy("K6b", tiled.render_v0))
    monkeypatch.setattr(renderer, "render_v0_feats",
                        spy("K8", renderer.render_v0_feats))
    system = _system(case, case["ckpt20"], f"--render_mode {mode}")
    rays = case["scene"].all_rays[:H * W]
    out = system.render_image(rays, chunk=512)
    assert out["rgb"].shape == (H * W, 3)
    assert bool(torch.isfinite(out["rgb"]).all())
    assert calls == ({"K6b": 2, "K8": 0} if mode == "tiled"
                     else {"K6b": 0, "K8": 2})


def test_finetune_cli_color_volume_trains_and_resumes(tmp_path,
                                                      monkeypatch, capsys):
    from mvsnerf_tpu_torch import train_finetune
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        from make_synthetic_scene import make_scene
    finally:
        sys.path.pop(0)
    make_scene(str(tmp_path / "dtu"))
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset_name", "dtu_ft", "--datadir",
            str(tmp_path / "dtu" / "scan1"), "--expname", "color",
            "--with_rgb_loss", "--use_color_volume", "--imgScale_train",
            "0.1", "--imgScale_test", "0.1", "--pad", "4", "--N_samples",
            "16", "--batch_size", "128", "--render_mode", "tiled",
            "--device", "cpu"]
    train_finetune.main(argv + ["--max_steps", "2"])
    train_finetune.main(argv + ["--max_steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 2" in out
    assert out.count("val view") == 8
    with open(tmp_path / "runs_fine_tuning" / "color" / "metrics.csv") as f:
        assert "val/PSNR" in f.readline()

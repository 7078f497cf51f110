"""The port's evaluation surface against the JAX package, on the CPU:

- metrics (PSNR with and without the DTU mask, SSIM, depth abs error and
  accuracy at a threshold, LPIPS on random .npz weights) against JAX's:
  abs <= 1e-4 (PSNR in dB), 1e-5 (SSIM, depth errors, LPIPS relative);
- the jet colormap against matplotlib's (skipped without matplotlib);
- render paths, the `interp` frame cap and `nearest_source_views`;
- `Evaluator.evaluate` in all three modes against JAX's chunked-mode
  evaluation of the same in-memory DTU-like scene (5 views of 32x32, GT
  depth, pad 4, 16 samples), or for `tiled` against the JAX metrics of
  JAX's exact render over its baked volume: PSNR abs <= 1e-2 dB, SSIM and
  abs_err abs <= 1e-3, acc@t within 2 pixels' share;
- the `evaluate` CLI end to end on `--device cpu` over
  scripts/make_synthetic_scene.py's scene with an exported checkpoint;
  with `--net_type v2` on a v2 checkpoint (whose keys are v0's) its
  render equals JAX's v2 render of the same volume and rays (abs <=
  1e-5 x (1 + max|ref|)) and not JAX's v0 render; `render_video` takes
  `--net_type v2` too.
"""

import json
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from torch_port_common import jax_mlp_params, jax_params, port_modules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(17)


# ------------------------------------------------------------- metrics ---

def _images(h=40, w=48):
    gt = RNG.uniform(0, 1, (h, w, 3)).astype(np.float32)
    pred = np.clip(gt + RNG.normal(0, 0.1, gt.shape), 0, 1).astype(
        np.float32)
    mask = RNG.uniform(0, 1, (h, w)) > 0.3
    return pred, gt, mask


def test_psnr_and_ssim_match_jax():
    from mvsnerf_tpu.eval import metrics as jm
    from mvsnerf_tpu_torch.eval import metrics as pm
    pred, gt, mask = _images()
    assert abs(float(pm.psnr(pred, gt)) - float(jm.psnr(pred, gt))) < 1e-4
    assert abs(float(pm.psnr(pred, gt, mask)) -
               float(jm.psnr(pred, gt, jnp.asarray(mask)))) < 1e-4
    assert abs(float(pm.ssim(pred, gt)) - float(jm.ssim(pred, gt))) < 1e-5
    assert abs(float(pm.ssim(pred[..., 0], gt[..., 0])) -
               float(jm.ssim(pred[..., 0], gt[..., 0]))) < 1e-5
    assert abs(float(pm.ssim(gt, gt)) - 1.0) < 1e-6


def test_depth_metrics_match_jax():
    from mvsnerf_tpu.eval import metrics as jm
    from mvsnerf_tpu_torch.eval import metrics as pm
    _, _, mask = _images()
    gt = RNG.uniform(2, 6, mask.shape).astype(np.float32) * mask
    pred = (gt + RNG.normal(0, 0.05, gt.shape)).astype(np.float32)
    np.testing.assert_allclose(pm.abs_error(pred, gt, mask).numpy(),
                               np.asarray(jm.abs_error(pred, gt, mask)),
                               rtol=0, atol=1e-6)
    for thr in (0.01, 0.05, 0.1):
        assert abs(float(pm.acc_threshold(pred, gt, mask, thr)) -
                   float(jm.acc_threshold(jnp.asarray(pred), jnp.asarray(gt),
                                          jnp.asarray(mask), thr))) < 1e-6


def _lpips_weights(path, seed=0):
    from mvsnerf_tpu.eval.metrics import _VGG16_CFG
    rng = np.random.default_rng(seed)
    out, cin, ci = {}, 3, 0
    for v in _VGG16_CFG:
        if v == "M":
            continue
        out[f"conv{ci}_kernel"] = (rng.standard_normal((3, 3, cin, v))
                                   .astype(np.float32) * 0.05)
        out[f"conv{ci}_bias"] = rng.normal(0, 0.01, v).astype(np.float32)
        cin, ci = v, ci + 1
    for j, c in enumerate([64, 128, 256, 512, 512]):
        out[f"lin{j}"] = np.abs(rng.standard_normal(c)).astype(np.float32)
    np.savez(path, **out)
    return str(path)


def test_lpips_matches_jax(tmp_path):
    from mvsnerf_tpu.eval.metrics import LPIPS as JaxLPIPS
    from mvsnerf_tpu_torch.eval.metrics import LPIPS
    path = _lpips_weights(tmp_path / "lpips.npz")
    a = RNG.uniform(-1, 1, (48, 64, 3)).astype(np.float32)
    b = np.clip(a + RNG.normal(0, 0.3, a.shape), -1, 1).astype(np.float32)
    ours, ref = float(LPIPS(path, "cpu")(a, b)), float(JaxLPIPS(path)(a, b))
    assert ref > 0 and abs(ours - ref) <= 1e-5 * ref
    assert float(LPIPS(path, "cpu")(a, a)) < 1e-6
    with pytest.raises(FileNotFoundError):
        LPIPS(str(tmp_path / "missing.npz"), "cpu")


def test_jet_matches_matplotlib():
    matplotlib = pytest.importorskip("matplotlib")
    from mvsnerf_tpu_torch.utils.vis import jet, visualize_depth
    x = np.concatenate([np.linspace(0, 1, 4097, dtype=np.float32),
                        RNG.uniform(0, 1, 1000).astype(np.float32)])
    ref = matplotlib.colormaps["jet"](x)[..., :3]
    np.testing.assert_allclose(jet(x), ref, rtol=0, atol=1e-12)
    depth = RNG.uniform(2, 6, (8, 9)).astype(np.float32)
    depth[0, 0] = 0.0
    img, (mi, ma) = visualize_depth(depth)
    assert img.shape == (8, 9, 3) and img.dtype == np.float32
    assert mi == depth[depth > 0].min() and ma == depth.max()


def test_vis_imports_no_matplotlib():
    import subprocess
    code = ("import sys, mvsnerf_tpu_torch.utils.vis as v, numpy as np\n"
            "v.visualize_depth(np.ones((2, 2)))\n"
            "assert 'matplotlib' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# --------------------------------------------------------------- paths ---

def test_render_paths_match_jax():
    from mvsnerf_tpu.eval import paths as jp
    from mvsnerf_tpu_torch.eval import paths as pp
    c2ws = np.stack([np.eye(4)] * 4)
    for i in range(4):
        c2ws[i, :3, 3] = [i, 0.1 * i, 0]
        c2ws[i, :3, :3] = jp.Rotation.from_euler(
            "xyz", [5 * i, -3 * i, 2 * i], degrees=True).as_matrix()
    for ours, ref in (
            (pp.gen_render_path(c2ws, 12), jp.gen_render_path(c2ws, 12)),
            (pp.nerf_video_path(10), jp.nerf_video_path(10)),
            (pp.pose_spherical_dtu(np.array([0.5, 0.4, 0.3]), 3.0, 8),
             jp.pose_spherical_dtu(np.array([0.5, 0.4, 0.3]), 3.0, 8)),
            (pp.create_spiral_poses(np.array([0.5, 0.5, 0.5]), 3.5, 7),
             jp.create_spiral_poses(np.array([0.5, 0.5, 0.5]), 3.5, 7)),
            (pp.create_spheric_poses(4.0, 9), jp.create_spheric_poses(4.0, 9)),
            (pp.pose_spherical_nerf(np.array([-30.0, 60.0, 0.0])),
             jp.pose_spherical_nerf(np.array([-30.0, 60.0, 0.0])))):
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
    assert pp.gen_render_path(c2ws, 12).shape == (16, 4, 4)


def test_interp_path_frame_cap_and_kinds():
    from mvsnerf_tpu_torch.eval.video import make_path

    class _DS:
        def load_poses_all(self):
            poses = np.stack([np.eye(4, dtype=np.float32)] * 49)
            poses[:, 0, 3] = np.arange(49) * 0.1
            return poses

    # 4 key poses -> 4 loop-closing segments x (60 // 3) = 80
    assert len(make_path("interp", dataset=_DS(), n_frames=60)) == 80
    for kind in ("spiral", "spheric", "nerf", "dtu"):
        assert len(make_path(kind, n_frames=6)) == 6
    with pytest.raises(ValueError):
        make_path("orbit")


def test_nearest_source_views_match_jax():
    from mvsnerf_tpu.eval.evaluate import nearest_source_views as jax_nsv
    from mvsnerf_tpu_torch.eval.evaluate import nearest_source_views
    c2ws = np.stack([np.eye(4)] * 12)
    c2ws[:, :3, 3] = RNG.standard_normal((12, 3))
    for i in range(12):
        tgt = c2ws[i].copy()
        tgt[:3, 3] += RNG.normal(0, 0.1, 3)
        np.testing.assert_array_equal(nearest_source_views(tgt, c2ws),
                                      jax_nsv(tgt, c2ws, 3))


# ----------------------------------------------------------- evaluator ---

class DepthScene:
    """tests/test_train.py's 5-view scene with GT depths (zero on a
    quarter of the pixels, as DTU's background)."""

    def __init__(self):
        from test_train import FakeSceneDataset
        self.inner = FakeSceneDataset()
        rng = np.random.default_rng(3)
        h, w = self.inner.imgs.shape[1:3]
        self.depth = rng.uniform(2.5, 5.0, (len(self.inner), h, w)).astype(
            np.float32) * (rng.uniform(0, 1, (len(self.inner), h, w)) > 0.25)
        self.poses = self.inner.c2ws

    def read_source_views(self, pair_idx=None):
        return self.inner.read_source_views(pair_idx)

    def __len__(self):
        return 2

    def __getitem__(self, i):
        # views 3 and 4: not sources, so no ray lands on a source's border
        return {**self.inner[i + 3], "depth": self.depth[i + 3]}


N_EVAL_SAMPLES = 16


@pytest.fixture(scope="module")
def eval_case():
    """JAX's chunked evaluation of DepthScene (fixed sources), and the
    metrics of JAX's exact render over its baked volume for `tiled`."""
    from test_train import PAD
    from mvsnerf_tpu.config import config_parser
    from mvsnerf_tpu.eval import metrics as jm
    from mvsnerf_tpu.eval.evaluate import Evaluator
    from mvsnerf_tpu.ops.geometry import get_ndc_coordinate
    from mvsnerf_tpu.ops.sampling import ray_marcher
    from mvsnerf_tpu.render.renderer import render_rays
    from mvsnerf_tpu.render.tiled import bake_color_volume
    ds = DepthScene()
    mlp_p, mvs_p = jax_params(4)
    args = config_parser(cmd=f"--pad {PAD} --N_samples {N_EVAL_SAMPLES} "
                             "--dataset_name llff")
    ev = Evaluator(args, ds, mvs_p, mlp_p)
    ref = ev.evaluate(chunk=512)
    volume, imgs, nf, pose = ev.build_volume()
    vol20 = bake_color_volume(volume, imgs, pose, nf, PAD)
    h, w = imgs.shape[1:3]
    tiled = []
    for i in range(len(ds)):
        s = ds[i]
        pts, _, rays_d, z = ray_marcher(jax.random.PRNGKey(0),
                                        jnp.asarray(s["rays"]),
                                        N_EVAL_SAMPLES, perturb=0.0)
        ndc = get_ndc_coordinate(pose["w2cs"][0], pose["intrinsics"][0],
                                 pts, jnp.asarray([w - 1.0, h - 1.0]),
                                 near=nf[0], far=nf[1], pad=PAD)
        out = render_rays(mlp_p, vol20, None, ndc, z, rays_d,
                          w2c_ref=pose["w2cs"][0], use_color_volume=True)
        pred = np.clip(np.asarray(out["rgb"]).reshape(h, w, 3), 0, 1)
        depth = np.asarray(out["depth"]).reshape(h, w)
        mask = s["depth"] > 0
        row = {"psnr": float(jm.psnr(pred, s["rgbs"], jnp.asarray(mask))),
               "ssim": float(jm.ssim(pred, s["rgbs"])),
               "abs_err": float(np.sum(np.asarray(jm.abs_error(
                   depth, s["depth"], mask))) / mask.sum())}
        for t in (0.01, 0.05, 0.1):
            row[f"acc_{t}"] = float(jm.acc_threshold(
                jnp.asarray(depth), jnp.asarray(s["depth"]),
                jnp.asarray(mask), t))
        tiled.append(row)
    return dict(ds=ds, params=(mlp_p, mvs_p), pad=PAD, ref=ref,
                tiled_ref=tiled)


def _compare_rows(ours, ref, n_pixels):
    assert set(ours) == set(ref), (set(ours), set(ref))
    for k in ref:
        tol = {"psnr": 1e-2, "ssim": 1e-3, "abs_err": 1e-3}.get(
            k, 2.0 / n_pixels)
        assert np.isfinite(ours[k]), k
        assert abs(ours[k] - ref[k]) <= tol, (k, ours[k], ref[k])


@pytest.mark.parametrize("mode", ["chunked", "hybrid", "tiled"])
def test_evaluate_matches_jax(eval_case, mode, tmp_path):
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator
    mlp, mvsnet = port_modules(*eval_case["params"])
    ev = Evaluator(mvsnet, mlp, n_samples=N_EVAL_SAMPLES,
                   pad=eval_case["pad"], chunk=300, device="cpu")
    out = ev.evaluate(eval_case["ds"], mode=mode, save_dir=str(tmp_path))
    refs = eval_case["tiled_ref"] if mode == "tiled" else \
        eval_case["ref"]["per_image"]
    assert len(out["per_image"]) == len(refs) == 2
    n_pixels = eval_case["ds"].depth[0].size
    for ours, ref in zip(out["per_image"], refs):
        _compare_rows(ours, ref, n_pixels)
    assert sorted(os.listdir(tmp_path)) == ["000.png", "001.png"]


def test_evaluate_per_image_sources_and_crop(eval_case):
    """Per-image sources rebuild the volume from the 3 nearest training
    views; the Blender crop scores the central 80 %."""
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator, \
        nearest_source_views
    ds = eval_case["ds"]
    mlp, mvsnet = port_modules(*eval_case["params"])
    ev = Evaluator(mvsnet, mlp, n_samples=8, pad=eval_case["pad"],
                   device="cpu")
    train = np.arange(3)
    out = ev.evaluate(ds, per_image_sources=True, train_c2ws=ds.poses[:3],
                      train_indices=train, val_c2ws=ds.poses[3:],
                      center_crop=True)
    assert set(out["mean"]) == {"psnr", "ssim"}
    assert all(np.isfinite(v) for r in out["per_image"] for v in r.values())
    # the evaluator's scene is the last image's: its nearest 3, view 0 the
    # nearest
    sel = nearest_source_views(ds.poses[4], ds.poses[:3])
    imgs = ds.read_source_views(train[sel])[0]
    np.testing.assert_allclose(
        ev.scene[1].numpy(), imgs * np.array([0.229, 0.224, 0.225]) +
        np.array([0.485, 0.456, 0.406]), atol=1e-5)


# ----------------------------------------------------------------- CLI ---

@pytest.fixture(scope="module")
def synthetic_scan(tmp_path_factory):
    """scripts/make_synthetic_scene.py's scan1 and a reference-format
    checkpoint of seeded weights."""
    from mvsnerf_tpu.io.torch_ckpt import export_reference_checkpoint
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        from make_synthetic_scene import make_scene
    finally:
        sys.path.pop(0)
    root = tmp_path_factory.mktemp("synth")
    make_scene(str(root / "dtu"))
    ckpt = str(root / "seeded.tar")
    export_reference_checkpoint(ckpt, *jax_params(0))
    return str(root / "dtu" / "scan1"), ckpt


@pytest.mark.parametrize("mode", ["chunked", "tiled"])
def test_evaluate_cli_on_cpu(synthetic_scan, tmp_path, monkeypatch, mode):
    from mvsnerf_tpu_torch import evaluate as cli
    datadir, ckpt = synthetic_scan
    monkeypatch.chdir(tmp_path)
    cli.main(["--dataset_name", "dtu_ft", "--datadir", datadir, "--ckpt",
              ckpt, "--expname", "cli", "--imgScale_train", "0.1",
              "--imgScale_test", "0.1", "--pad", "4", "--N_samples", "16",
              "--chunk", "256", "--render_mode", mode, "--device", "cpu"])
    with open(tmp_path / "results" / "cli" / "metrics.json") as f:
        out = json.load(f)
    # the 4 views of the dtu test split, each from its own nearest sources
    assert len(out["per_image"]) == 4
    for row in out["per_image"]:
        assert set(row) == {"psnr", "ssim", "abs_err", "acc_0.01",
                            "acc_0.05", "acc_0.1"}
        assert all(np.isfinite(v) for v in row.values())
    assert len([f for f in os.listdir(tmp_path / "results" / "cli")
                if f.endswith(".png")]) == 4


def test_evaluate_cli_train_split_info(synthetic_scan):
    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.data.dtu_ft import DTUFTDataset
    from mvsnerf_tpu_torch.evaluate import train_split_info
    args = config_parser(f"--datadir {synthetic_scan[0]} --imgScale_test 0.1"
                         " --imgScale_train 0.1 --dataset_name dtu_ft")
    ds = DTUFTDataset(args, "val")
    train_idx, train_c2ws, val_c2ws = train_split_info(ds, args)
    assert len(train_idx) == 16 and train_c2ws.shape == (16, 4, 4)
    np.testing.assert_allclose(val_c2ws, ds.poses, atol=1e-5)
    # the focal at this dataset's scale, as read_meta sets it
    assert ds.focal[0] == pytest.approx(180.0 * 0.1 * 4, rel=1e-6)


def test_evaluate_cli_renders_a_v2_checkpoint_as_v2(synthetic_scan,
                                                    tmp_path, monkeypatch):
    """A v2 (`Renderer_linear`) checkpoint has v0's keys and shapes, so it
    loads into either MLP strictly; `--net_type v2` must render it as v2.
    The CLI's first image against JAX's chunked render of the port's own
    volume and rays with the v2 MLP and with the v0 MLP of the same
    weights."""
    from mvsnerf_tpu.config import config_parser as jax_config
    from mvsnerf_tpu.eval.evaluate import Evaluator as JaxEvaluator
    from mvsnerf_tpu.io.torch_ckpt import export_reference_checkpoint
    from mvsnerf_tpu_torch import evaluate as cli
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator
    datadir, _ = synthetic_scan
    mlp_p, mvs_p = jax_mlp_params("v2", 7), jax_params(0)[1]
    ckpt = str(tmp_path / "v2.tar")
    export_reference_checkpoint(ckpt, mlp_p, mvs_p)
    seen = []
    render = Evaluator.render

    def recording(self, rays, H, W, mode="chunked"):
        out = render(self, rays, H, W, mode)
        seen.append((self.mlp.net_type, [a for a in self.scene], rays,
                     out["rgb"]))
        return out

    monkeypatch.setattr(Evaluator, "render", recording)
    monkeypatch.chdir(tmp_path)
    flags = ["--imgScale_train", "0.1", "--imgScale_test", "0.1", "--pad",
             "4", "--N_samples", "16"]
    cli.main(["--dataset_name", "dtu_ft", "--datadir", datadir, "--ckpt",
              ckpt, "--expname", "v2", "--fixed_sources", "--render_mode",
              "chunked", "--chunk", "256", "--device", "cpu",
              "--net_type", "v2", *flags])
    assert len(seen) == 4 and all(s[0] == "v2" for s in seen)
    _, (volume, imgs, nf, pose), rays, rgb = seen[0]
    refs = {}
    for net_type in ("v2", "v0"):
        jev = JaxEvaluator(jax_config(flags + ["--net_type", net_type]),
                           None, mvs_p, mlp_p)
        refs[net_type] = np.asarray(jev.render_rays_buffer(
            np.asarray(rays), jnp.asarray(volume.numpy()),
            jnp.asarray(imgs.numpy()), nf.numpy(),
            {k: jnp.asarray(v.numpy()) for k, v in pose.items()},
            chunk=1024)["rgb"])
    ours = rgb.numpy()
    tol = 1e-5 * (1 + np.abs(refs["v2"]).max())
    np.testing.assert_allclose(ours, refs["v2"], rtol=0, atol=tol)
    assert np.abs(ours - refs["v0"]).max() > 100 * tol


def test_render_video_takes_net_type_v2(synthetic_scan, tmp_path,
                                        monkeypatch):
    """`render_video --net_type v2` builds the fine-tune system with the
    v2 MLP from the checkpoint and renders on the chunked route."""
    from mvsnerf_tpu.io.torch_ckpt import export_reference_checkpoint
    from mvsnerf_tpu_torch import render_video as cli
    from mvsnerf_tpu_torch.train.finetune import FinetuneSystem
    datadir, _ = synthetic_scan
    ckpt = str(tmp_path / "v2.tar")
    export_reference_checkpoint(ckpt, jax_mlp_params("v2", 7),
                                jax_params(0)[1])
    systems = []
    init = FinetuneSystem.__init__

    def recording(self, *a, **kw):
        init(self, *a, **kw)
        systems.append(self)

    monkeypatch.setattr(FinetuneSystem, "__init__", recording)
    monkeypatch.chdir(tmp_path)
    frames = cli.main(["--dataset_name", "dtu_ft", "--datadir", datadir,
                       "--ckpt", ckpt, "--expname", "v2", "--imgScale_train",
                       "0.1", "--pad", "4", "--N_samples", "8", "--device",
                       "cpu", "--net_type", "v2"], n_frames=3)
    assert systems[0].mlp.net_type == "v2"
    assert frames and all(np.isfinite(f).all() for f in frames)

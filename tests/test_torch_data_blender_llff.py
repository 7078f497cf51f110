"""The port's Blender and LLFF datasets, `get_ndc_rays` and the slice on
both, against the JAX package, on the CPU.

The scenes are written here by `mvsnerf_tpu_torch.data.synthetic` into
directories named `lego` and `fern`, so the real pair tables pick their
views (`lego` reads frames up to 70, `fern` images up to 19): Blender at
imgScale 0.04 (32x32, from 64x64 RGBA PNGs), LLFF at 0.1 (96x64, from
192x128 PNGs).

- Loaders: the port's and JAX's share their numpy arithmetic, so rays,
  colours, masks, focal, img_wh, poses, `read_source_views` and
  `load_poses_all` are held bit-equal (no float order differs), LLFF's NDC
  route (`spheric_poses=False`) too.
- Geometry: `get_ndc_rays` on tensors against JAX's and against JAX
  LLFF's numpy route, within 1e-6 x each value's max; on numpy arrays (the
  port's LLFF NDC route) bit-equal to JAX LLFF's.
- Helpers (`center_poses`, `average_pose`, `resize_nearest(out_wh=)`,
  `load_image(keep_alpha=)`, `unnormalize_imagenet`): bit-equal.
- The slice on each dataset (pad 4, 128 planes, 16 samples): the encoding
  volume against JAX `mvsnet_apply` within 1e-4 x (1 + max) (the slice
  test's rule); renders of 256 val rays (Blender onto white) against JAX's
  exact route, `render_rays(fast_volume_grad=False, mlp_impl="xla")`,
  rgb within 1e-4; one fine-tune step against JAX autodiff of that route
  with Adam (test_torch_finetune.py's tolerances: loss rel 1e-5,
  gradients 1e-4 x max|g|, updated MLP weights 1e-5), on the first batch
  without the rays near a ReLU kink or through a source view's own
  pixels (both rules of test_torch_finetune.py).
- The CLIs with `--device cpu` on both datasets, the refusals of the
  fusion and generalizable CLIs, and the dataset registry.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from torch_port_common import jax_params

PAD, N_SAMPLES, BATCH, KINK, KEPT = 4, 16, 256, 5e-6, 160
SCALE = {"blender": 0.04, "llff": 0.1}
WH = {"blender": (32, 32), "llff": (96, 64)}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    from mvsnerf_tpu_torch.data import synthetic
    from mvsnerf_tpu_torch.data.pairs import get_split
    root = tmp_path_factory.mktemp("scenes")
    frames = np.concatenate([get_split("lego", "train"),
                             get_split("lego", "val")])
    synthetic.write_blender_scene(str(root / "lego"), res=64, frames=frames,
                                  seed=1)
    synthetic.write_llff_scene(str(root / "fern"), wh=(192, 128), seed=2)
    return {"blender": str(root / "lego"), "llff": str(root / "fern")}


def _args(scenes, name):
    return SimpleNamespace(datadir=scenes[name], imgScale_train=SCALE[name],
                           imgScale_test=SCALE[name])


def _pair(scenes, name, split, **kw):
    """(port dataset, JAX dataset) of one split."""
    from mvsnerf_tpu.data import dataset_dict as jax_dict
    from mvsnerf_tpu_torch.data import dataset_dict
    args = _args(scenes, name)
    return (dataset_dict[name](args, split, **kw),
            jax_dict[name](args, split, **kw))


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------ loaders ---

@pytest.mark.parametrize("split", ["train", "val"])
def test_blender_matches_jax(scenes, split):
    ours, ref = _pair(scenes, "blender", split)
    assert ours.img_wh == ref.img_wh == WH["blender"]
    n = 16 if split == "train" else 4
    assert len(ours.img_idx) == n
    np.testing.assert_array_equal(ours.img_idx, ref.img_idx)
    assert ours.focal == ref.focal and ours.white_back
    for key in ("all_rays", "all_rgbs", "poses"):
        np.testing.assert_array_equal(getattr(ours, key), getattr(ref, key))
    if split == "train":
        assert ours.all_rays.shape == (n * 32 * 32, 8)
        assert (ours.all_rays[:, 6:] == [2.0, 6.0]).all()
    else:
        assert ours.all_rgbs.shape == (n, 32, 32, 3)
        np.testing.assert_array_equal(ours.all_masks, ref.all_masks)
        # the alpha disc: clear corners are white after the blend
        assert 0.2 < ours.all_masks.mean() < 0.9
        np.testing.assert_array_equal(ours.all_rgbs[:, 0, 0], 1.0)
        _equal_trees(ours[1], ref[1])
    _equal_trees(ours.read_source_views(), ref.read_source_views())
    _equal_trees(ours.read_source_views(pair_idx=[63, 6, 43]),
                 ref.read_source_views(pair_idx=[63, 6, 43]))
    np.testing.assert_array_equal(ours.load_poses_all(),
                                  ref.load_poses_all())
    assert len(ours) == len(ref)


@pytest.mark.parametrize("split,spheric", [("train", True), ("val", True),
                                           ("train", False)])
def test_llff_matches_jax(scenes, split, spheric):
    ours, ref = _pair(scenes, "llff", split, spheric_poses=spheric)
    assert ours.img_wh == ref.img_wh == WH["llff"]
    assert ours.focal == ref.focal and len(ours.focal) == 2
    np.testing.assert_array_equal(ours.img_idx, ref.img_idx)
    for key in ("all_rays", "all_rgbs", "poses", "bounds"):
        np.testing.assert_array_equal(getattr(ours, key), getattr(ref, key))
    nf = ours.all_rays.reshape(-1, 8)[:, 6:]
    if spheric:
        # each image's bounds x [0.8, 1.2], after the near rescale: the
        # nearest bound is 1 / 0.75
        assert nf[:, 0].min() >= 0.8 / 0.75 - 1e-6 and \
            nf[:, 1].max() > 8 * nf[:, 0].min()
    else:
        np.testing.assert_array_equal(np.unique(nf), [0.0, 1.0])
    _equal_trees(ours.read_source_views(), ref.read_source_views())
    np.testing.assert_array_equal(ours.load_poses_all(),
                                  ref.load_poses_all())
    if split == "val":
        _equal_trees(ours[2], ref[2])


def test_read_source_views_needs_the_pair_table(scenes, tmp_path):
    """JAX's quirk, kept: the source views come from the pair table with
    no fallback, so a scene it does not name raises (blender.py:84-85,
    llff.py:117-118), though the splits fall back to every frame."""
    from mvsnerf_tpu_torch.data.blender import BlenderDataset
    other = tmp_path / "not_a_scene"
    os.symlink(scenes["blender"], other)
    ds = BlenderDataset(SimpleNamespace(datadir=str(other),
                                        imgScale_train=0.04,
                                        imgScale_test=0.04),
                        "train", load_ref=True)
    with pytest.raises(KeyError, match="not_a_scene_train"):
        ds.read_source_views()


def test_bad_scales_raise(scenes):
    from mvsnerf_tpu_torch.data.blender import BlenderDataset
    from mvsnerf_tpu_torch.data.llff import LLFFDataset
    with pytest.raises(ValueError, match="divisible by 32"):
        BlenderDataset(SimpleNamespace(datadir=scenes["blender"],
                                       imgScale_train=0.05), "train")
    with pytest.raises(ValueError, match="divisible by 32"):
        LLFFDataset(SimpleNamespace(datadir=scenes["llff"],
                                    imgScale_train=0.07), "train")


def test_registry_and_per_scene_datasets():
    from mvsnerf_tpu.data import dataset_dict as jax_dict
    from mvsnerf_tpu_torch.data import dataset_dict, per_scene_dataset
    assert dataset_dict.keys() == jax_dict.keys() == \
        {"dtu", "dtu_ft", "blender", "llff"}
    for name in ("dtu_ft", "blender", "llff"):
        assert per_scene_dataset(name) is dataset_dict[name]
        assert dataset_dict[name].__name__ == jax_dict[name].__name__
    with pytest.raises(ValueError, match="train_mvs_nerf"):
        per_scene_dataset("dtu")


# ----------------------------------------------------- geometry, helpers ---

def test_get_ndc_rays_matches_jax_and_numpy():
    from mvsnerf_tpu.ops.geometry import get_ndc_rays as jax_ndc
    from mvsnerf_tpu.data.llff import _get_ndc_rays
    from mvsnerf_tpu_torch.ops.geometry import get_ndc_rays
    rng = np.random.default_rng(4)
    rays_o = rng.uniform(-0.3, 0.3, (500, 3)).astype(np.float32)
    rays_d = np.concatenate([rng.uniform(-0.4, 0.4, (500, 2)),
                             -rng.uniform(0.8, 1.2, (500, 1))],
                            -1).astype(np.float32)
    focal = [77.6, 69.0]
    o, d = get_ndc_rays(64, 96, focal, 1.0, torch.from_numpy(rays_o),
                        torch.from_numpy(rays_d))
    assert o.dtype == torch.float32 and o.shape == (500, 3)
    for ref in (jax_ndc(64, 96, focal, 1.0, jnp.asarray(rays_o),
                        jnp.asarray(rays_d)),
                _get_ndc_rays(64, 96, focal, 1.0, rays_o, rays_d)):
        for a, b in zip((o, d), ref):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-6 * np.abs(b).max())
    # on numpy arrays (LLFF's NDC route): JAX's numpy route bit for bit
    focal64 = [np.float64(f) for f in focal]
    for a, b in zip(get_ndc_rays(64, 96, focal64, 1.0, rays_o, rays_d),
                    _get_ndc_rays(64, 96, focal64, 1.0, rays_o, rays_d)):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_pose_helpers_bit_equal():
    from mvsnerf_tpu.data import common as jc
    from mvsnerf_tpu_torch.data import common as pc
    rng = np.random.default_rng(5)
    poses = rng.standard_normal((7, 3, 4))
    np.testing.assert_array_equal(pc.average_pose(poses),
                                  jc.average_pose(poses))
    _equal_trees(pc.center_poses(poses), jc.center_poses(poses))
    np.testing.assert_array_equal(pc.BLENDER2OPENCV, jc.BLENDER2OPENCV)
    x = rng.uniform(0, 1, (5, 3)).astype(np.float32)
    np.testing.assert_array_equal(pc.unnormalize_imagenet(x),
                                  jc.unnormalize_imagenet(x))
    img = rng.uniform(0, 1, (37, 53)).astype(np.float32)
    for kw in ({"out_wh": (20, 11)}, {"out_wh": (70, 90)},
               {"fx": 0.5, "fy": 0.25}):
        np.testing.assert_array_equal(pc.resize_nearest(img, **kw),
                                      jc.resize_nearest(img, **kw))


@pytest.mark.parametrize("mode,keep_alpha", [("RGBA", True), ("RGBA", False),
                                             ("L", True), ("L", False),
                                             ("RGB", True)])
def test_load_image_bit_equal(tmp_path, mode, keep_alpha):
    from PIL import Image

    from mvsnerf_tpu.data.common import load_image as jax_load
    from mvsnerf_tpu_torch.data.common import load_image
    rng = np.random.default_rng(6)
    shape = {"RGBA": (40, 30, 4), "RGB": (40, 30, 3), "L": (40, 30)}[mode]
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(rng.integers(0, 256, shape, np.uint8), mode).save(path)
    for wh in (None, (16, 24)):
        ours = load_image(path, wh, keep_alpha=keep_alpha)
        np.testing.assert_array_equal(
            ours, jax_load(path, wh, keep_alpha=keep_alpha))
        channels = {("RGBA", True): 4, ("L", True): None}.get(
            (mode, keep_alpha), 3)
        assert ours.shape[2:] == (() if channels is None else (channels,))


# ------------------------------------------------------------- the slice ---

def _jax_volume(params, src):
    from mvsnerf_tpu.models import mvsnet_apply
    imgs_norm, projs, nf, _ = src
    return np.asarray(mvsnet_apply(
        params[1], jnp.asarray(imgs_norm), jnp.asarray(projs),
        jnp.asarray(nf, jnp.float32), pad=PAD, warp_mode="packed",
        costreg_impl="plain", featurenet_impl="plain")[0])


def _jax_loss_fn(src, white_bkgd):
    """JAX's exact-route fine-tune loss of {mlp, volume} on a ray batch,
    unjittered (the reference step of test_torch_finetune.py)."""
    from mvsnerf_tpu.ops.geometry import get_ndc_coordinate
    from mvsnerf_tpu.ops.sampling import ray_marcher
    from mvsnerf_tpu.render.renderer import render_rays
    from mvsnerf_tpu.train.common import unpreprocess_images
    imgs_norm, _, nf, pose = src
    imgs = unpreprocess_images(jnp.asarray(imgs_norm))
    w2cs, intrs = jnp.asarray(pose["w2cs"]), jnp.asarray(pose["intrinsics"])
    near_far = jnp.asarray(nf, jnp.float32)
    h, w = imgs.shape[1:3]
    inv_scale = jnp.asarray([w - 1.0, h - 1.0])

    def render(params, rays):
        pts, _, rays_d, z = ray_marcher(jax.random.PRNGKey(0), rays,
                                        N_SAMPLES, perturb=0.0)
        ndc = get_ndc_coordinate(w2cs[0], intrs[0], pts, inv_scale,
                                 near=near_far[0], far=near_far[1], pad=PAD)
        return render_rays(params["mlp"], params["volume"], pts, ndc, z,
                           rays_d, w2c_ref=w2cs[0], w2cs=w2cs,
                           intrinsics=intrs, imgs=imgs,
                           white_bkgd=white_bkgd, fast_volume_grad=False,
                           mlp_impl="xla")

    def loss_fn(params, rays, rgbs):
        return jnp.mean((render(params, rays)["rgb"] - rgbs) ** 2)

    return render, loss_fn


@pytest.fixture(scope="module", params=["blender", "llff"])
def slice_case(request, scenes, tmp_path_factory):
    """One dataset: its train and val splits, the JAX weights and volume,
    and reference checkpoints without and with that volume."""
    from mvsnerf_tpu.io.torch_ckpt import export_reference_checkpoint
    from mvsnerf_tpu_torch.data import dataset_dict
    name = request.param
    args = _args(scenes, name)
    train = dataset_dict[name](args, "train")
    val = dataset_dict[name](args, "val")
    params = jax_params(7)
    src = train.read_source_views()
    volume = _jax_volume(params, src)
    ck = tmp_path_factory.mktemp(f"ck_{name}")
    plain, with_vol = str(ck / "ref.tar"), str(ck / "ref_vol.tar")
    export_reference_checkpoint(plain, *params)
    export_reference_checkpoint(with_vol, *params, volume=volume)
    return dict(name=name, args=args, train=train, val=val, params=params,
                src=src, volume=volume, ckpt=plain, ckpt_vol=with_vol,
                white=name == "blender")


def _system(case, ckpt):
    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.train.finetune import FinetuneSystem
    white = "--white_bkgd" if case["white"] else ""
    args = config_parser(
        f"--dataset_name {case['name']} --datadir {case['args'].datadir} "
        f"--pad {PAD} --N_samples {N_SAMPLES} --batch_size {BATCH} "
        f"--with_rgb_loss --perturb 0 --ckpt {ckpt} {white}")
    return FinetuneSystem(args, case["train"], case["val"], device="cpu")


def test_slice_volume_matches_jax(slice_case):
    """The fine-tune system's MVSNet volume on the dataset's sources."""
    system = _system(slice_case, slice_case["ckpt"])
    ref = slice_case["volume"]
    w, h = WH[slice_case["name"]]
    assert ref.shape == (128, h // 4 + 2 * PAD, w // 4 + 2 * PAD, 8)
    np.testing.assert_allclose(system.volume.detach().numpy(), ref, rtol=0,
                               atol=1e-4 * (1 + np.abs(ref).max()))


@pytest.mark.parametrize("mode", ["chunked", "hybrid"])
def test_slice_render_matches_jax(slice_case, mode):
    """256 rays of the first val view through `Evaluator.render` (onto
    white for Blender) against JAX's exact route on JAX's volume."""
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator
    from torch_port_common import port_modules
    mlp, mvsnet = port_modules(*slice_case["params"])
    ev = Evaluator(mvsnet, mlp, n_samples=N_SAMPLES, pad=PAD,
                   white_bkgd=slice_case["white"], chunk=100, device="cpu")
    ev.build_volume(*slice_case["src"])
    rays = slice_case["val"][0]["rays"][::max(
        1, len(slice_case["val"][0]["rays"]) // 256)][:256]
    out = ev.render(rays, 16, 16, mode=mode)
    render, _ = _jax_loss_fn(slice_case["src"], slice_case["white"])
    ref = jax.jit(render)({"mlp": slice_case["params"][0],
                           "volume": jnp.asarray(slice_case["volume"])},
                          jnp.asarray(rays))
    np.testing.assert_allclose(out["rgb"].numpy(), np.asarray(ref["rgb"]),
                               rtol=0, atol=1e-4)
    acc = np.asarray(ref["acc"])
    if slice_case["white"]:
        # onto white: the background's share shows in every channel
        assert acc.min() < 0.9
        assert np.all(np.asarray(ref["rgb"]) >= 1 - acc[:, None] - 1e-5)


def test_slice_finetune_step_matches_jax(slice_case):
    """One step of the port's trainer from JAX's volume and weights on the
    dataset's first batch (rays within KINK of a ReLU kink left out, as in
    test_torch_finetune.py) against JAX autodiff of the exact route with
    optax's Adam under the step schedule."""
    from mvsnerf_tpu.utils.schedulers import make_lr_schedule
    from mvsnerf_tpu_torch.io.torch_ckpt import state_dicts_from_jax
    from mvsnerf_tpu_torch.ops.mlp_train import relu_margin
    from mvsnerf_tpu_torch.train.common import RayBatchIterator
    train = slice_case["train"]
    system = _system(slice_case, slice_case["ckpt_vol"])
    np.testing.assert_array_equal(system.volume.detach().numpy(),
                                  slice_case["volume"])
    b = next(RayBatchIterator({"rays": train.all_rays,
                               "rgbs": train.all_rgbs}, BATCH, seed=0))
    margin = relu_margin(system.mlp, system.mlp_input(
        torch.from_numpy(b["rays"]))).reshape(BATCH, -1)
    # a source view's own rays project back onto its pixel grid exactly,
    # where the in-image mask at its border flips on one ulp (two such
    # rays of the LLFF batch differ by 3e-3 in rgb): they are left out
    centres = slice_case["src"][3]["c2ws"][:, :3, 3]
    own = (b["rays"][:, None, :3] == centres[None]).all(-1).any(-1)
    keep = np.flatnonzero((margin.amin(1) > KINK).numpy() & ~own)[:KEPT]
    assert len(keep) == KEPT and own.any()
    rays, rgbs = b["rays"][keep], b["rgbs"][keep]
    loss = float(system._step(torch.from_numpy(rays),
                              torch.from_numpy(rgbs)))

    _, loss_fn = _jax_loss_fn(slice_case["src"], slice_case["white"])
    mlp_p = slice_case["params"][0]
    params = {"mlp": mlp_p, "volume": jnp.asarray(slice_case["volume"])}
    ref, grads = jax.jit(jax.value_and_grad(loss_fn))(
        params, jnp.asarray(rays), jnp.asarray(rgbs))
    assert abs(loss - float(ref)) <= 1e-5 * abs(float(ref))
    gv = np.asarray(grads["volume"])
    assert np.abs(gv).max() > 0
    np.testing.assert_allclose(system.volume.grad.numpy(), gv, rtol=0,
                               atol=1e-4 * np.abs(gv).max())
    ref_g = state_dicts_from_jax(jax.tree.map(np.asarray, grads["mlp"]),
                                 slice_case["params"][1])[0]
    named = dict(system.mlp.named_parameters())
    for name, g in ref_g.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   rtol=0, atol=1e-4 * g.abs().max().item(),
                                   err_msg=name)
    opt = optax.adam(make_lr_schedule(5e-4, "steplr", (5000, 8000, 9000),
                                      0.5, num_steps=80000), b1=0.9, b2=0.999)
    updates, _ = opt.update(grads, opt.init(params), params)
    after = state_dicts_from_jax(jax.tree.map(
        np.asarray, optax.apply_updates(params, updates)["mlp"]),
        slice_case["params"][1])[0]
    for name, p in after.items():
        np.testing.assert_allclose(named[name].detach().numpy(), p.numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


# ----------------------------------------------------------------- CLIs ---

def _cli_argv(case, expname, extra=()):
    white = ["--white_bkgd"] if case["white"] else []
    scale = str(SCALE[case["name"]])
    return ["--dataset_name", case["name"], "--datadir",
            case["args"].datadir, "--expname", expname, "--ckpt",
            case["ckpt"], "--imgScale_train", scale, "--imgScale_test",
            scale, "--pad", str(PAD), "--N_samples", "8", "--batch_size",
            "64", "--chunk", "256", "--with_rgb_loss", "--device", "cpu",
            *white, *extra]


def test_clis_on_the_cpu(slice_case, tmp_path, monkeypatch, capsys):
    """train_finetune (2 steps, then the 4 val views), evaluate (the val
    split, each view from its 3 nearest training views) and render_video
    (3 frames of the dataset's path kind) with `--device cpu`."""
    from mvsnerf_tpu_torch import evaluate, render_video, train_finetune
    monkeypatch.chdir(tmp_path)
    name = slice_case["name"]
    train_finetune.main(_cli_argv(slice_case, "ft", ["--max_steps", "2"]))
    out = capsys.readouterr().out
    assert out.count("val view") == 4 and "nan" not in out
    assert os.listdir("runs_fine_tuning/ft/ckpts") == ["ckpt_000000002.pt"]

    res = evaluate.main(_cli_argv(slice_case, "ev"))
    assert len(res["per_image"]) == 4
    assert sorted(os.listdir("results/ev")) == \
        ["000.png", "001.png", "002.png", "003.png", "metrics.json"]
    assert all(np.isfinite(v) for v in res["mean"].values())
    w, h = WH[name]
    from PIL import Image
    assert Image.open("results/ev/000.png").size == (3 * w, h)

    frames = render_video.main(_cli_argv(
        slice_case, "vid", ["--ckpt", "runs_fine_tuning/ft/ckpts/"
                            "ckpt_000000002.pt"]), n_frames=3)
    assert len(frames) == 3 and frames[0].shape == (h, 2 * w, 3)
    assert os.path.getsize("results/vid.gif") > 0
    assert render_video.PATH_KIND[name] == \
        {"blender": "nerf", "llff": "spheric"}[name]


def test_train_split_info_matches_jax(slice_case):
    """The eval CLI's per-image protocol finds the pair table's training
    views of `lego` / `fern` as the root evaluate.py does."""
    from evaluate import train_split_info as jax_info
    from mvsnerf_tpu_torch.evaluate import train_split_info
    ours = train_split_info(slice_case["val"], slice_case["args"])
    _, ref_val = _pair({slice_case["name"]: slice_case["args"].datadir},
                       slice_case["name"], "val")
    ref = jax_info(ref_val, slice_case["args"])
    assert len(ours[0]) == 16
    _equal_trees(ours, ref)


@pytest.mark.parametrize("cli,reason", [
    ("train_fusion", "fusion.py:104-105"),
    ("train_mvs_nerf", "generalizable.py:100-104")])
@pytest.mark.parametrize("name", ["blender", "llff"])
def test_fusion_and_generalizable_refuse(scenes, cli, reason, name):
    import importlib
    main = importlib.import_module(f"mvsnerf_tpu_torch.{cli}").main
    with pytest.raises(NotImplementedError, match=reason):
        main(["--dataset_name", name, "--datadir", scenes[name],
              "--device", "cpu"])

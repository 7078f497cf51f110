"""The port's DTU scene writer and post-hoc metric tools against the JAX
package's root scripts, on the CPU:

- `data.synthetic.write_dtu_scene` / `write_dtu_multiscan` and the
  `make_synthetic_scene` CLI write the same bytes as
  scripts/make_synthetic_scene.py (every camera file, PNG, `.pfm` and
  `scans.txt`), and the port's `dtu` and `dtu_ft` loaders read the same
  first sample from either tree;
- `convert_lpips_weights.from_state_dicts` gives the same arrays, bit for
  bit, as scripts/convert_lpips_weights.py on seeded state dicts;
- `metrics_from_panels --device cpu` gives the rows of
  scripts/metrics_from_panels.py in both input modes, with `--crop 0.1`
  and LPIPS on seeded weights: PSNR within 1e-4 dB, SSIM within 1e-5,
  LPIPS within 1e-5 of JAX's;
- `LPIPS` and `metrics_from_panels` run on the card unless told the CPU,
  and raise with no card.
"""

import functools
import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_views=4, img_hw=(64, 96))


def jax_script(name):
    """The JAX package's scripts/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tree_digest(root):
    """{path relative to root: sha256 of the file} of every file."""
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def default_trees(tmp_path_factory):
    """scan1 at the default size (49 views, 240x192, 1200x1600 depths),
    written by the port's CLI and by JAX's script: (port root, JAX root)."""
    from mvsnerf_tpu_torch import make_synthetic_scene
    ours = str(tmp_path_factory.mktemp("dtu_port"))
    ref = str(tmp_path_factory.mktemp("dtu_jax"))
    make_synthetic_scene.main([ours])
    jax_script("make_synthetic_scene").make_scene(ref)
    return ours, ref


def test_write_dtu_scene_small_bytes_equal(tmp_path):
    from mvsnerf_tpu_torch.data.synthetic import write_dtu_scene
    write_dtu_scene(str(tmp_path / "ours"), scan="scan9", seed=3, **SMALL)
    jax_script("make_synthetic_scene").make_scene(
        str(tmp_path / "ref"), scan="scan9", seed=3, **SMALL)
    ours, ref = tree_digest(tmp_path / "ours"), tree_digest(tmp_path / "ref")
    assert len(ours) == 4 * (1 + 7 + 1) and ours == ref


def test_write_dtu_scene_default_bytes_equal(default_trees):
    ours, ref = (tree_digest(r) for r in default_trees)
    assert len(ours) == 49 * (1 + 7 + 1) and ours == ref
    with open(os.path.join(default_trees[0], "Depths", "scan1",
                           "depth_map_0000.pfm"), "rb") as f:
        assert f.read(3) == b"Pf\n" and f.readline() == b"1600 1200\n"


def test_write_dtu_multiscan_matches_jax(tmp_path, monkeypatch):
    """The multi-scan tree and its scans.txt; JAX's make_multiscan calls
    its make_scene at the default size, cut here to SMALL for both."""
    from mvsnerf_tpu_torch.data.synthetic import write_dtu_multiscan
    scans = ["scan3", "scan4"]
    write_dtu_multiscan(str(tmp_path / "ours"), scans, **SMALL)
    script = jax_script("make_synthetic_scene")
    monkeypatch.setattr(script, "make_scene",
                        functools.partial(script.make_scene, **SMALL))
    script.make_multiscan(str(tmp_path / "ref"), scans)
    ours, ref = tree_digest(tmp_path / "ours"), tree_digest(tmp_path / "ref")
    assert "scans.txt" in ours and ours == ref
    assert (tmp_path / "ours" / "scans.txt").read_text() == "scan3\nscan4\n"


def test_make_synthetic_scene_cli_usage():
    from mvsnerf_tpu_torch import make_synthetic_scene
    with pytest.raises(SystemExit):
        make_synthetic_scene.main([])


def _same_sample(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _same_sample(a[k], b[k])
        elif isinstance(a[k], (np.ndarray, list, tuple)):
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("dataset", ["dtu", "dtu_ft"])
def test_loaders_read_the_same_first_sample(default_trees, dataset):
    """The port's loaders on the port's tree and on JAX's: the first
    train sample of `dtu` (3 sources + target, GT depths through the
    native library), and `dtu_ft`'s first val view with GT depth and its
    source views."""
    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.data.dtu import MVSDatasetDTU
    from mvsnerf_tpu_torch.data.dtu_ft import DTUFTDataset
    samples = []
    for root in default_trees:
        if dataset == "dtu":
            ds = MVSDatasetDTU(root, "train", scan_list=["scan1"])
            samples.append(ds[0])
        else:
            args = config_parser(
                f"--dataset_name dtu_ft --datadir {root}/scan1 "
                "--imgScale_train 0.25 --imgScale_test 0.25")
            ds = DTUFTDataset(args, "val")
            imgs, projs, near_far, pose = ds.read_source_views()
            samples.append(dict(ds[0], imgs=imgs, projs=projs,
                                near_far=near_far, **pose))
    ours, ref = samples
    if dataset == "dtu":
        assert ours["images"].shape == (4, 192, 240, 3)
        assert ours["depths_h"].shape == (4, 512, 640)
    else:
        assert ours["rgbs"].shape == (128, 160, 3)
        assert ours["depth"].shape == (128, 160)
    _same_sample(ours, ref)


def seeded_lpips_state_dicts(tmp_path, seed=0):
    """A torchvision-format VGG16 state dict (He-initialised convolutions,
    small biases) and lpips heads drawn from `seed`, saved with
    torch.save: (vgg path, lin path)."""
    from mvsnerf_tpu_torch.eval.metrics import VGG16_CFG
    from mvsnerf_tpu_torch.convert_lpips_weights import VGG16_CONV_IDX
    gen = torch.Generator().manual_seed(seed)
    vgg, cin = {}, 3
    widths = [v for v in VGG16_CFG if v != "M"]
    for idx, cout in zip(VGG16_CONV_IDX, widths):
        vgg[f"features.{idx}.weight"] = torch.randn(
            cout, cin, 3, 3, generator=gen) * (2.0 / (9 * cin)) ** 0.5
        vgg[f"features.{idx}.bias"] = torch.randn(cout, generator=gen) * 0.01
        cin = cout
    lin = {f"lin{j}.model.1.weight": torch.rand(1, c, 1, 1, generator=gen)
           for j, c in enumerate([64, 128, 256, 512, 512])}
    paths = str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg_lin.pth")
    torch.save(vgg, paths[0])
    torch.save(lin, paths[1])
    return paths


def test_convert_lpips_weights_bit_equal(tmp_path):
    from mvsnerf_tpu_torch import convert_lpips_weights
    vgg, lin = seeded_lpips_state_dicts(tmp_path)
    ours = convert_lpips_weights.from_state_dicts(vgg, lin)
    ref = jax_script("convert_lpips_weights").from_state_dicts(vgg, lin)
    assert sorted(ours) == sorted(ref) and len(ours) == 13 * 2 + 5
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k],
                                                                ref[k]), k
    out = str(tmp_path / "lpips.npz")
    convert_lpips_weights.main(["--out", out, "--vgg_pth", vgg,
                                "--lin_pth", lin])
    with np.load(out) as data:
        assert all(np.array_equal(data[k], ref[k]) for k in ref)


def test_convert_lpips_weights_without_lpips(tmp_path, monkeypatch):
    """The lpips-package route, with no lpips importable, exits as JAX's
    does."""
    from mvsnerf_tpu_torch import convert_lpips_weights
    monkeypatch.setitem(sys.modules, "lpips", None)
    with pytest.raises(SystemExit, match="lpips package not installed"):
        convert_lpips_weights.main(["--out", str(tmp_path / "x.npz")])


@pytest.fixture(scope="module")
def scored_images(tmp_path_factory):
    """3 [gt | pred | depth] panels of 40x56 images, the same as separate
    pred and GT PNGs, and LPIPS weights converted from seeded state
    dicts."""
    from PIL import Image
    from mvsnerf_tpu_torch.convert_lpips_weights import main as convert
    root = tmp_path_factory.mktemp("panels")
    rng = np.random.default_rng(7)
    for d in ("panels", "pred", "gt"):
        os.makedirs(root / d)
    for i in range(3):
        gt = rng.integers(0, 256, (40, 56, 3), np.uint8)
        pred = np.clip(gt + rng.normal(0, 20, gt.shape), 0, 255).astype(
            np.uint8)
        depth = rng.integers(0, 256, (40, 56, 3), np.uint8)
        Image.fromarray(np.concatenate([gt, pred, depth], 1)).save(
            root / "panels" / f"{i:03d}.png")
        Image.fromarray(pred).save(root / "pred" / f"{i:03d}.png")
        Image.fromarray(gt).save(root / "gt" / f"{i:03d}.png")
    weights = str(root / "lpips.npz")
    vgg, lin = seeded_lpips_state_dicts(root)
    convert(["--out", weights, "--vgg_pth", vgg, "--lin_pth", lin])
    return root, weights


@pytest.mark.parametrize("mode", ["panels", "pairs"])
def test_metrics_from_panels_matches_jax(scored_images, tmp_path,
                                         monkeypatch, mode):
    from mvsnerf_tpu_torch import metrics_from_panels
    root, weights = scored_images
    if mode == "panels":
        inputs = ["--panels", str(root / "panels" / "*.png"),
                  "--width", "56"]
    else:
        inputs = ["--pred", str(root / "pred" / "*.png"),
                  "--gt", str(root / "gt" / "*.png")]
    argv = inputs + ["--crop", "0.1", "--lpips_weights", weights]
    ref_json = str(tmp_path / "jax.json")
    monkeypatch.setattr(sys, "argv", ["metrics_from_panels.py", *argv,
                                      "--out", ref_json])
    jax_script("metrics_from_panels").main()
    with open(ref_json) as f:
        ref = json.load(f)
    ours = metrics_from_panels.main(argv + ["--device", "cpu", "--out",
                                            str(tmp_path / "port.json")])
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == ours
    assert len(ours["per_image"]) == len(ref["per_image"]) == 3
    for a, b in zip(ours["per_image"] + [ours["mean"]],
                    ref["per_image"] + [ref["mean"]]):
        assert a.keys() == b.keys() and a.get("file") == b.get("file")
        assert abs(a["psnr"] - b["psnr"]) <= 1e-4
        assert abs(a["ssim"] - b["ssim"]) <= 1e-5
        assert b["lpips"] > 0 and abs(a["lpips"] - b["lpips"]) <= \
            1e-5 * b["lpips"]


def test_metrics_run_on_the_card_unless_told_the_cpu(scored_images,
                                                     monkeypatch):
    """LPIPS(path) and metrics_from_panels without --device take the card
    (`resolve_device`): with none they raise. LPIPS(path, "cpu") runs on
    the CPU."""
    from mvsnerf_tpu_torch import metrics_from_panels
    from mvsnerf_tpu_torch.eval.metrics import LPIPS
    root, weights = scored_images
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LPIPS(weights)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        metrics_from_panels.main(["--panels", str(root / "panels" / "*.png"),
                                  "--lpips_weights", weights])
    lp = LPIPS(weights, "cpu")
    assert lp.device.type == "cpu" and lp.lins[0].device.type == "cpu"
    x = torch.zeros(16, 16, 3)
    assert float(lp(x, x)) == 0.0

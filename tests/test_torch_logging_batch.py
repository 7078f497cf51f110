"""The port's logger, batch driver and generalizable validation panels
against the JAX package, on the CPU.

- MetricLogger: given the same calls, the port's and JAX's loggers write
  TensorBoard events with the same tags, steps and values (images: the
  same PNG bytes), read with tensorboardX's `event_pb2` over the TFRecord
  framing, and the same CSV; with `tensorboardX` unimportable, both write
  the CSV alone (JAX's own behaviour, not a device fallback).
- run_batch: `scene_commands` and the port's `main` give the root
  run_batch.py's commands (its `run` recording them) with its two scripts
  mapped to the port's `-m` modules, and each command's flags parse with
  the port's config_parser to the values they name.
- the generalizable CLI (`--device cpu`, one step, `--N_vis 1`) writes a
  `val_00` panel equal to JAX's `panel([target, clip(rgb), depth vis])`
  of the same arrays, converted as JAX's `save_panel` converts it.
"""

import importlib.util
import os
import struct
import sys

import numpy as np
import pytest

from test_torch_generalizable import dtu_tree  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _log(logger, image):
    """The same calls for both loggers."""
    logger.log_scalars(0, {"train/loss": 0.5, "train/PSNR": 20.125})
    logger.log_scalars(100, {"train/loss": 0.25, "train/PSNR": 23.0,
                             "train/depth_loss": 0.0625})
    logger.log_image(100, "val/panel", image)
    logger.log_scalars(200, {"val/PSNR": 24.5})
    logger.flush()


def _events(log_dir):
    """(step, tag, value...) of every summary value in the TensorBoard
    event files of `log_dir` (TFRecord framing: u64 length, u32 crc,
    payload, u32 crc)."""
    from tensorboardX.proto import event_pb2
    out = []
    for name in sorted(os.listdir(log_dir)):
        if not name.startswith("events.out.tfevents"):
            continue
        with open(os.path.join(log_dir, name), "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            (n,) = struct.unpack_from("<Q", data, pos)
            ev = event_pb2.Event()
            ev.ParseFromString(data[pos + 12:pos + 12 + n])
            pos += 12 + n + 4
            for v in ev.summary.value:
                if v.HasField("image"):
                    im = v.image
                    out.append((ev.step, v.tag, im.height, im.width,
                                im.colorspace, im.encoded_image_string))
                else:
                    out.append((ev.step, v.tag, v.simple_value))
    return out


def _both(tmp_path):
    from mvsnerf_tpu.utils.logging import MetricLogger as JaxLogger
    from mvsnerf_tpu_torch.utils.logging import MetricLogger
    image = np.random.default_rng(0).uniform(-0.2, 1.2, (6, 9, 3))
    loggers = MetricLogger(str(tmp_path / "port")), \
        JaxLogger(str(tmp_path / "jax"))
    for logger in loggers:
        _log(logger, image)
    return [str(tmp_path / d) for d in ("port", "jax")]


def test_tensorboard_events_equal_jaxs(tmp_path, capsys):
    pytest.importorskip("tensorboardX")
    ours, ref = _both(tmp_path)
    assert "TensorBoard events in" in capsys.readouterr().out
    events = _events(ours)
    assert events == _events(ref)
    assert [e[:2] for e in events] == [
        (0, "train/loss"), (0, "train/PSNR"), (100, "train/loss"),
        (100, "train/PSNR"), (100, "train/depth_loss"), (100, "val/panel"),
        (200, "val/PSNR")]
    assert events[-1][2] == 24.5 and events[5][2:5] == (6, 9, 3)
    with open(os.path.join(ours, "metrics.csv")) as f, \
            open(os.path.join(ref, "metrics.csv")) as g:
        assert f.read() == g.read()


def test_without_tensorboardx_both_write_csv_only(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    ours, ref = _both(tmp_path)
    assert "no tensorboardX: CSV only" in capsys.readouterr().out
    assert os.listdir(ours) == os.listdir(ref) == ["metrics.csv"]
    with open(os.path.join(ours, "metrics.csv")) as f, \
            open(os.path.join(ref, "metrics.csv")) as g:
        rows = f.read()
        assert rows == g.read()
    assert rows.splitlines()[0] == \
        "step,train/loss,train/PSNR,train/depth_loss,val/PSNR"


# ------------------------------------------------------------ run_batch ---

def _jax_commands(monkeypatch, argv):
    """The root run_batch.py's commands for `argv`, its `run` recording
    them, its two scripts mapped to the port's modules."""
    spec = importlib.util.spec_from_file_location(
        "root_run_batch", os.path.join(ROOT, "run_batch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cmds = []
    monkeypatch.setattr(mod, "run", cmds.append)
    monkeypatch.setattr(sys, "argv", ["run_batch.py", *argv])
    mod.main()
    modules = {"train_mvs_nerf_finetuning.py":
               ["-m", "mvsnerf_tpu_torch.train_finetune"],
               "evaluate.py": ["-m", "mvsnerf_tpu_torch.evaluate"]}
    return [[c[0], *modules[c[1]], *c[2:]] for c in cmds], mod


@pytest.mark.parametrize("dataset", ["blender", "llff"])
def test_scene_commands_are_jaxs(monkeypatch, dataset):
    from mvsnerf_tpu_torch import run_batch
    from mvsnerf_tpu_torch.config import config_parser
    argv = [dataset, "/data/root", "/ck/mvsnerf-v0.tar"]
    want, mod = _jax_commands(monkeypatch, argv)
    scenes = mod.BLENDER_SCENES if dataset == "blender" else mod.LLFF_SCENES
    assert (run_batch.BLENDER_SCENES, run_batch.LLFF_SCENES) == \
        (mod.BLENDER_SCENES, mod.LLFF_SCENES)
    assert [c for s in scenes for c in run_batch.scene_commands(
        *argv, s)] == want
    got = []
    monkeypatch.setattr(run_batch, "run", got.append)
    run_batch.main(argv)
    assert got == want and len(got) == 16
    for cmd in want:
        flags = cmd[3:]
        args = vars(config_parser(flags))
        for i, tok in enumerate(flags):
            if not tok.startswith("--"):
                continue
            key = tok[2:]
            assert key in args, tok
            value = flags[i + 1] if i + 1 < len(flags) and \
                not flags[i + 1].startswith("--") else True
            assert str(args[key]) == str(value) or \
                float(args[key]) == float(value), tok


# --------------------------------------------------- validation panels ---

def test_generalizable_cli_writes_jaxs_panel(dtu_tree, tmp_path,  # noqa
                                             monkeypatch):
    from PIL import Image
    from mvsnerf_tpu.utils.vis import panel, visualize_depth
    from mvsnerf_tpu_torch.train.generalizable import GeneralizableSystem
    from mvsnerf_tpu_torch.train_mvs_nerf import main
    seen = []
    render_view = GeneralizableSystem.render_view

    def spy(self, sample, chunk=8192):
        out = render_view(self, sample, chunk)
        seen.append(out)
        return out

    monkeypatch.setattr(GeneralizableSystem, "render_view", spy)
    monkeypatch.chdir(tmp_path)
    main(["--dataset_name", "dtu", "--datadir", dtu_tree, "--scan_list",
          os.path.join(dtu_tree, "scans.txt"), "--expname", "val",
          "--imgScale_train", "0.25", "--imgScale_test", "0.25", "--pad",
          "4", "--N_samples", "8", "--batch_size", "64", "--N_vis", "1",
          "--device", "cpu", "--max_steps", "1"])
    run = tmp_path / "runs_new" / "val"
    assert len(seen) == 1
    out = seen[0]
    want = panel([out["target"], np.clip(out["rgb"], 0, 1),
                  visualize_depth(out["depth"])[0]])
    want = (np.clip(want, 0, 1) * 255).astype("uint8")  # save_panel's
    got = np.asarray(Image.open(run / "val_00_00000001.png"))
    h, w = out["target"].shape[:2]
    assert got.shape == (h, 3 * w, 3)
    np.testing.assert_array_equal(got, want)
    with open(run / "metrics.csv") as f:
        assert "val/PSNR" in f.readline()

"""The port imports torch, numpy and scipy only: never jax, flax, msgpack
or mvsnerf_tpu (it reads and writes JAX's `.msgpack` snapshots with its
own codec), and none of matplotlib, imageio or PIL at import (the card's
machine has PIL but neither matplotlib nor imageio; the image loader, the
scene writers and the PNG and video writers import theirs inside the
function); importing a kernel module or the native host library builds
nothing (this machine has no nvcc)."""

import os
import subprocess
import sys

import pytest

SLICE_MODULES = [
    "mvsnerf_tpu_torch",
    "mvsnerf_tpu_torch.ops.geometry",
    "mvsnerf_tpu_torch.ops.sampling",
    "mvsnerf_tpu_torch.ops.encoding",
    "mvsnerf_tpu_torch.ops.compositing",
    "mvsnerf_tpu_torch.ops.interp",
    "mvsnerf_tpu_torch.ops.homography",
    "mvsnerf_tpu_torch.ops.sweep",
    "mvsnerf_tpu_torch.ops.color_warp",
    "mvsnerf_tpu_torch.ops.render_fused",
    "mvsnerf_tpu_torch.models.layers",
    "mvsnerf_tpu_torch.models.mvsnet",
    "mvsnerf_tpu_torch.models.nerf_mlp",
    "mvsnerf_tpu_torch.io.torch_ckpt",
    "mvsnerf_tpu_torch.render.renderer",
    "mvsnerf_tpu_torch.render.hybrid",
    "mvsnerf_tpu_torch.eval.evaluate",
    "mvsnerf_tpu_torch.ops.volume_gather",
    "mvsnerf_tpu_torch.ops.mlp_train",
    "mvsnerf_tpu_torch.utils.schedulers",
    "mvsnerf_tpu_torch.utils.logging",
    "mvsnerf_tpu_torch.io.checkpoint",
    "mvsnerf_tpu_torch.config",
    "mvsnerf_tpu_torch.data.common",
    "mvsnerf_tpu_torch.data.pairs",
    "mvsnerf_tpu_torch.data.dtu_ft",
    "mvsnerf_tpu_torch.train.common",
    "mvsnerf_tpu_torch.train.finetune",
    "mvsnerf_tpu_torch.train_finetune",
    "mvsnerf_tpu_torch.data.dtu",
    "mvsnerf_tpu_torch.train.generalizable",
    "mvsnerf_tpu_torch.train_mvs_nerf",
    "mvsnerf_tpu_torch.ops.costreg_conv",
    "mvsnerf_tpu_torch.render.tiled",
    "mvsnerf_tpu_torch.eval.metrics",
    "mvsnerf_tpu_torch.eval.paths",
    "mvsnerf_tpu_torch.eval.video",
    "mvsnerf_tpu_torch.utils.vis",
    "mvsnerf_tpu_torch.evaluate",
    "mvsnerf_tpu_torch.render_video",
    "mvsnerf_tpu_torch.train.fusion",
    "mvsnerf_tpu_torch.train_fusion",
    "mvsnerf_tpu_torch.data",
    "mvsnerf_tpu_torch.data.blender",
    "mvsnerf_tpu_torch.data.llff",
    "mvsnerf_tpu_torch.data.synthetic",
    "mvsnerf_tpu_torch.native",
    "mvsnerf_tpu_torch.parallel",
    "mvsnerf_tpu_torch.parallel.mesh",
    "mvsnerf_tpu_torch.parallel.sharding",
    "mvsnerf_tpu_torch.io.flax_msgpack",
    "mvsnerf_tpu_torch.io.jax_snapshot",
    "mvsnerf_tpu_torch.utils.profiling",
    "mvsnerf_tpu_torch.run_batch",
    "mvsnerf_tpu_torch.make_synthetic_scene",
    "mvsnerf_tpu_torch.metrics_from_panels",
    "mvsnerf_tpu_torch.convert_lpips_weights",
]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_never_imports_jax():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
            "                                    'msgpack', 'mvsnerf_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


def test_port_never_imports_pil():
    """The card's machine has no matplotlib or imageio: only
    `data.common.load_image`, `data.synthetic`'s writers,
    `utils.vis.write_png` (PIL) and `eval.video.write_frames` (imageio
    where it has a video backend, else PIL) import one, inside the
    function."""
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('PIL', 'matplotlib', 'imageio'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


def test_native_imports_without_building():
    code = ("import mvsnerf_tpu_torch.native as n\n"
            "import mvsnerf_tpu_torch.train.common, mvsnerf_tpu_torch.data\n"
            "assert n._lib is None and not n._build_failed\n"
            "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


@pytest.mark.parametrize("module", ["sweep", "color_warp", "render_fused",
                                    "volume_gather", "mlp_train",
                                    "costreg_conv"])
def test_kernel_module_imports_without_building(module):
    code = ("import mvsnerf_tpu_torch._build as b\n"
            f"import mvsnerf_tpu_torch.ops.{module}\n"
            "assert b._lib is None\n"
            "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


@pytest.mark.parametrize("module", ["render.tiled", "render.hybrid",
                                    "eval.evaluate", "train.finetune",
                                    "evaluate", "render_video"])
def test_render_module_imports_without_building(module):
    """The modules that launch K6, K6b and K8 import without a build, with
    every launch counter at 0."""
    code = ("import mvsnerf_tpu_torch._build as b\n"
            f"import mvsnerf_tpu_torch.{module}\n"
            "from mvsnerf_tpu_torch.ops.render_fused import render_v0, \\\n"
            "    render_v0_feats\n"
            "assert b._lib is None\n"
            "assert render_v0.launches == render_v0.baked_launches == 0\n"
            "assert render_v0_feats.launches == 0\n"
            "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr

"""The port imports torch and numpy only: never jax, never mvsnerf_tpu, and
importing a kernel module builds nothing (this machine has no nvcc)."""

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
            "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
            "                                    'mvsnerf_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


def test_port_never_imports_pil():
    """The card's machine has no PIL: only `data.common.load_image`, which
    chip_smoke.py never calls, imports it."""
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'PIL' not in sys.modules\n"
            "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


@pytest.mark.parametrize("module", ["sweep", "color_warp", "render_fused",
                                    "volume_gather", "mlp_train"])
def test_kernel_module_imports_without_building(module):
    code = ("import mvsnerf_tpu_torch._build as b\n"
            f"import mvsnerf_tpu_torch.ops.{module}\n"
            "assert b._lib is None\n"
            "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr

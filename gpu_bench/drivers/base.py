"""What the drivers share: seeded weights handed to the program through a
reference-format checkpoint, the plain reference, the program's flags."""

from __future__ import annotations

import contextlib
import importlib
import os
import tempfile

import numpy as np
import torch

from .. import core


class BaseDriver:

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.device = torch.device(device)
        # [weights, images, order, sample, fits...]
        self.seeds = core.seeds(seed, 8)
        self.ref = importlib.import_module(
            f"gpu_bench.reference.{cfg['reference']}")
        self.limits = mix["limits"]

    def mark(self, name: str):
        """Marks the end of a phase of set-up (`run.run_cell` sets it)."""

    def program_args(self, flags):
        """The program's flags with the seeded weights as `--ckpt`; the
        weights stay in `self.params` for the reference."""
        self.weights = core.make_weights(self.ref.param_table(),
                                         self.seeds[0], self.device)
        self.params = core.flat_params(self.weights)
        tmp = tempfile.mkdtemp(prefix="gpu_bench_")
        self._ckpt = core.write_checkpoint(
            self.weights, os.path.join(tmp, "seeded.tar"))
        self.mark("weights")
        if self.device.type == "cpu":
            flags = [*flags, "--device", "cpu"]
        args = core.program_args(["--ckpt", self._ckpt, *flags,
                                  *self.mix.get("flags", [])])
        for flag, key in (("N_samples", "samples_per_ray"), ("pad", "pad")):
            if getattr(args, flag) != self.cfg[key]:
                raise ValueError(f"the program's --{flag} "
                                 f"{getattr(args, flag)} is not the "
                                 f"configuration's {key} {self.cfg[key]}")
        return args

    def drop_ckpt(self):
        path = getattr(self, "_ckpt", None)
        if path:
            os.remove(path)
            os.rmdir(os.path.dirname(path))
            self._ckpt = None

    def sample(self, n_done: int, k: int) -> list:
        """k of the window's n_done answers, drawn from the seed once the
        window has closed (the last one always among them)."""
        rng = np.random.default_rng(self.seeds[3])
        pick = rng.choice(max(n_done - 1, 0), size=min(k - 1, n_done - 1),
                          replace=False) if n_done > 1 else []
        return sorted({*map(int, pick), n_done - 1})

    @contextlib.contextmanager
    def precision(self, tf32: bool):
        """The reference's precision: float32 with TF32 off, or, for the
        control, TF32 in matmuls and convolutions."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old

    def compared(self, readings: dict) -> dict:
        return {k: {"value": float(v), "limit": float(self.limits[k])}
                for k, v in readings.items()}

    def check(self) -> dict:
        got = self.program_outputs()
        self._ref32 = self.reference(tf32=False)
        return self.compared(self.readings(got, self._ref32))

    def control_readings(self) -> dict:
        """The check's numbers for the reference in TF32 put in the
        program's place (run after `check`)."""
        return self.readings(self.reference(tf32=True), self._ref32)

    def fault_readings(self) -> dict:
        return {}

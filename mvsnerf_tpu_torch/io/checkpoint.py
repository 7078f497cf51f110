"""Native snapshots: atomic `torch.save` files with resume (counterpart of
mvsnerf_tpu/io/checkpoint.py).

A snapshot is any picklable state (the fine-tune trainer saves params,
optimizer state, scheduler state and `global_step`), written to a
temporary file and moved into place with `os.replace`, so a crash never
leaves a torn latest snapshot. The newest `keep` snapshots are kept.
Reading the JAX package's `.msgpack` snapshots is not supported.
"""

from __future__ import annotations

import os
import re

import torch


def save_checkpoint(ckpt_dir: str, state, step: int, prefix: str = "ckpt_",
                    keep: int = 3) -> str:
    """Atomically write `state` at `step`; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{prefix}{step:09d}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    for _, old in sorted(_list_snapshots(ckpt_dir, prefix))[:-keep]:
        try:
            os.remove(old)
        except OSError:
            pass
    return path


def _list_snapshots(ckpt_dir: str, prefix: str):
    pat = re.compile(re.escape(prefix) + r"(\d+)\.pt$")
    out = []
    for name in os.listdir(ckpt_dir):
        m = pat.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return out


def latest_checkpoint(ckpt_dir: str, prefix: str = "ckpt_"):
    """(step, path) of the newest snapshot in `ckpt_dir`, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    snaps = sorted(_list_snapshots(ckpt_dir, prefix))
    return snaps[-1] if snaps else None


def load_checkpoint(path: str, device=None):
    """The state saved at `path`, tensors mapped to `device`."""
    return torch.load(path, map_location=device, weights_only=True)

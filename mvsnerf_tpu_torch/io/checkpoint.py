"""Native snapshots: atomic `torch.save` files with resume (counterpart of
mvsnerf_tpu/io/checkpoint.py).

A snapshot is any picklable state (the fine-tune trainer saves params,
optimizer state, scheduler state and `global_step`), written to a
temporary file and moved into place with `os.replace`, so a crash never
leaves a torn latest snapshot. The newest `keep` snapshots are kept.

A run's directory resumes from its newest `ckpt_*.pt`; when it holds
none, from its newest `ckpt_*.msgpack`, so that a port run pointed at a
JAX run's `ckpts/` resumes it (io/jax_snapshot.py reads those). A file
path is taken by its suffix: `.msgpack` is a JAX snapshot, anything else
a port one.
"""

from __future__ import annotations

import os
import re

import torch

from .jax_snapshot import read_jax_snapshot


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


def _list_snapshots(ckpt_dir: str, prefix: str, suffix: str = ".pt"):
    pat = re.compile(re.escape(prefix) + r"(\d+)" + re.escape(suffix) + "$")
    out = []
    for name in os.listdir(ckpt_dir):
        m = pat.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return out


def latest_checkpoint(ckpt_dir: str, prefix: str = "ckpt_"):
    """(step, path) of the newest `.pt` snapshot in `ckpt_dir`, else of
    its newest JAX `.msgpack` snapshot, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    for suffix in (".pt", ".msgpack"):
        snaps = sorted(_list_snapshots(ckpt_dir, prefix, suffix))
        if snaps:
            return snaps[-1]
    return None


def snapshot_path(ckpt_path_or_dir: str, strict: bool = False):
    """The snapshot a trainer's `restore` reads: a file path is that
    file, a directory its `latest_checkpoint`. None when there is none
    (FileNotFoundError instead when `strict`)."""
    if os.path.isfile(ckpt_path_or_dir):
        return ckpt_path_or_dir
    latest = latest_checkpoint(ckpt_path_or_dir)
    if latest is None:
        if strict:
            raise FileNotFoundError(f"no ckpt_*.pt or ckpt_*.msgpack "
                                    f"snapshot in {ckpt_path_or_dir!r}")
        return None
    return latest[1]


def read_snapshot(path: str, kind: str, system):
    """The `state()` dict in the snapshot at `path` for `system`, a
    trainer of `kind`: a JAX `.msgpack` through
    io/jax_snapshot.read_jax_snapshot, else `load_checkpoint` onto its
    device."""
    if path.endswith(".msgpack"):
        return read_jax_snapshot(path, kind, system)
    return load_checkpoint(path, system.device)


def load_checkpoint(path: str, device=None):
    """The state saved at `path`, tensors mapped to `device`."""
    return torch.load(path, map_location=device, weights_only=True)

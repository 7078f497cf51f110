"""Metric logging (counterpart of mvsnerf_tpu/utils/logging.py): scalars to
`<log_dir>/metrics.csv` always, and to TensorBoard events in `log_dir`
when `tensorboardX` imports, as JAX does (utils/logging.py:13-24); image
panels as PNGs beside them, and into TensorBoard with `log_image`.

Without `tensorboardX` the logger writes the CSV and the PNGs only, JAX's
own behaviour. The import runs in the constructor, not at module import.
"""

from __future__ import annotations

import csv
import os


class MetricLogger:
    """One CSV row per `log_scalars` call; the header grows with new keys
    (the file is then rewritten with the union header). Prints its sinks
    once, when it is made."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(log_dir)
        self.csv_path = os.path.join(log_dir, "metrics.csv")
        self._keys = ["step"]
        self._rows = []
        if self._tb is not None:
            print(f"logging to {self.csv_path} and TensorBoard events in "
                  f"{log_dir}")
        else:
            print(f"logging to {self.csv_path}" + (
                " (no tensorboardX: CSV only)" if use_tensorboard else ""))

    def log_scalars(self, step: int, scalars: dict):
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)
        row = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        self._rows.append(row)
        new_keys = [k for k in row if k not in self._keys]
        self._keys += new_keys
        if new_keys or not os.path.exists(self.csv_path):
            with open(self.csv_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._keys)
                w.writeheader()
                w.writerows(self._rows)
        else:
            with open(self.csv_path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._keys).writerow(row)

    def log_image(self, step: int, tag: str, image):
        """An (H, W, 3) [0, 1] image into TensorBoard as CHW under `tag`
        (nothing without tensorboardX)."""
        import numpy as np
        if self._tb is not None:
            img = np.clip(np.asarray(image), 0, 1)
            self._tb.add_image(tag, img.transpose(2, 0, 1), step)

    def save_panel(self, step: int, name: str, image):
        """Write an (H, W, 3) [0, 1] image as `<log_dir>/<name>_<step>.png`
        (JAX utils/logging.py:58, reference train_mvs_nerf_pl.py:247-250);
        returns the path."""
        from .vis import write_png
        path = os.path.join(self.log_dir, f"{name}_{step:08d}.png")
        write_png(path, image)
        return path

    def flush(self):
        if self._tb is not None:
            self._tb.flush()

"""Scalar logging to `<log_dir>/metrics.csv` (the CSV half of
mvsnerf_tpu/utils/logging.py's MetricLogger; TensorBoard and image panels
are not ported yet)."""

from __future__ import annotations

import csv
import os


class MetricLogger:
    """One CSV row per `log_scalars` call; the header grows with new keys
    (the file is then rewritten with the union header)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.csv_path = os.path.join(log_dir, "metrics.csv")
        self._keys = ["step"]
        self._rows = []

    def log_scalars(self, step: int, scalars: dict):
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

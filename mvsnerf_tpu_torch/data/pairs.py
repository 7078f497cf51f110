"""Per-scene train/val/test view splits (counterpart of
mvsnerf_tpu/data/pairs.py), read from the port's copy of the pair tables,
`configs/pairs.json` (57 entries `{scene}_{train,val,test}`)."""

from __future__ import annotations

import json
import os

import numpy as np

PAIRS_PATH = os.path.join(os.path.dirname(__file__), "..", "configs",
                          "pairs.json")
_cache = None


def load_pairs(path: str | None = None) -> dict:
    """{name: np.ndarray of view indices} for `{scene}_{split}` keys."""
    global _cache
    if path is None and _cache is not None:
        return _cache
    with open(path or PAIRS_PATH) as f:
        data = {k: np.asarray(v) for k, v in json.load(f).items()}
    if path is None:
        _cache = data
    return data


def get_split(scene: str, split: str, path: str | None = None):
    pairs = load_pairs(path)
    key = f"{scene}_{split}"
    if key not in pairs:
        raise KeyError(f"no pair split '{key}'; known scenes: "
                       f"{sorted({k.rsplit('_', 1)[0] for k in pairs})}")
    return pairs[key]

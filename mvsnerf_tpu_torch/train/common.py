"""Shared training utilities: batch iteration, prefetching, image
unpreprocessing (counterpart of mvsnerf_tpu/train/common.py)."""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..data.common import IMAGENET_MEAN, IMAGENET_STD


def unpreprocess_images(imgs):
    """Undo the ImageNet normalisation of (..., 3) channel-last images
    (reference train_*.py `unpreprocess`)."""
    mean = torch.tensor(IMAGENET_MEAN, device=imgs.device)
    std = torch.tensor(IMAGENET_STD, device=imgs.device)
    return imgs * std + mean


class RayBatchIterator:
    """Shuffled fixed-size batches from flat numpy ray buffers, the
    replacement for the reference's DataLoader(batch_size=1024) over the
    per-scene datasets. Infinite; reshuffles each epoch with the same
    `default_rng(seed)` permutations as the JAX package's iterator, so one
    seed gives the same batches in both."""

    def __init__(self, arrays: dict, batch_size: int, seed: int = 0):
        self.arrays = arrays
        self.n = len(next(iter(arrays.values())))
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self._perm = None
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._perm is None or self._pos + self.batch_size > self.n:
            self._perm = self.rng.permutation(self.n)
            self._pos = 0
        idx = self._perm[self._pos: self._pos + self.batch_size]
        self._pos += self.batch_size
        return {k: v[idx] for k, v in self.arrays.items()}


class Prefetcher:
    """Background-thread batch prefetch: overlaps host-side batch assembly
    (shuffle + gather) with the device step, the role of the reference's
    DataLoader workers (train_mvs_nerf_finetuning_pl.py:126-131)."""

    def __init__(self, iterator, depth: int = 2):
        self._it = iterator
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        while not self._stop.is_set():
            batch = next(self._it)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.25)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        """Stop the thread and wait for it."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

"""Operations and bytes of each layer of work, counted once from shapes.

A multiply-add counts as two operations, whichever kernel or library call
computes it: no extra 3xTF32 passes, no zeroing, no recomputation. Each
input byte is read once and each output byte written once. The peaks the
counts are divided by are `peaks.json`'s."""

import json
import os

with open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "peaks.json")) as _f:
    PEAKS = json.load(_f)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the f32-equivalent peak and the bytes over the memory bandwidth."""
    return max(flops / PEAKS["flops_f32"], nbytes / PEAKS["bytes_per_s"])

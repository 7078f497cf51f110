"""The program's own spans in a traced run: the `mvsnerf.<name>` ranges
that `mvsnerf_tpu_torch/utils/profiling.py` `trace_context` enters on the
host, on the profiler's clock beside the device's operations.

The program's spans are not user annotations, so the profiler puts no
range of theirs on the device's timeline. A span's device range is rebuilt
from the operations launched inside it: each device operation's
correlation id names the runtime call (`cudaLaunchKernel`,
`cudaMemcpyAsync`, ...) that launched it, at a time on the host's clock,
and the host's spans at that time are the ones it belongs to (a span
holds what its children launched). The device's busy intervals follow
`core.Trace`'s rule (the union of its operations' intervals, the host's
mirrored ranges left out); each idle gap between them is split by overlap
among the innermost spans the host was in over it, so a gap that starts in
one span and ends in the next is shared between them.

The readers divide by the number of the cell's top spans in the window
(`eval.render` a request, `video.frame` a frame, `train.step` a step),
counted where the work happens, and return None when that count is not
the window's own (`requests`, `frames`, `steps`), or when the program
has no such span (a program without spans reads nothing)."""

from __future__ import annotations

import bisect

import torch

from .core import _ns

PREFIX = "mvsnerf."


class ProgramSpans:
    """The spans of a trace, on the host thread that entered `top`.

    count: the number of `top` spans. busy: the device's busy intervals
    (ns). idle_inner / idle_root: device-idle seconds between busy
    intervals by the innermost span and by the outermost span the host
    was in (None: in no span)."""

    def __init__(self, prof, top: str):
        cuda = torch.autograd.DeviceType.CUDA
        host_names, spans, launched, dev_events = set(), [], {}, []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                dev_events.append(e)
                continue
            name = e.name()
            host_names.add(name)
            if name.startswith(PREFIX):
                start = _ns(e, "start")
                spans.append((e.start_thread_id(), start,
                              start + _ns(e, "duration"), name[len(PREFIX):]))
            elif name.startswith("cu"):
                # a runtime call, by the ids its device operation carries
                launched[e.correlation_id(), e.linked_correlation_id()] = \
                    _ns(e, "start")
        thread = next((th for th, _, _, name in spans if name == top), None)
        spans = sorted(((s, t, name) for th, s, t, name in spans
                        if th == thread), key=lambda sp: (sp[0], -sp[1]))
        self.names = [name for _, _, name in spans]
        self.count = self.names.count(top)
        dev = []
        for e in dev_events:
            if e.name() not in host_names and \
                    not getattr(e, "is_user_annotation", lambda: False)():
                start = _ns(e, "start")
                dev.append((start, start + _ns(e, "duration"), launched.get(
                    (e.correlation_id(), e.linked_correlation_id()))))
        self.busy = []
        for s, t, _ in sorted(dev, key=lambda d: d[:2]):
            if self.busy and s <= self.busy[-1][1]:
                self.busy[-1][1] = max(self.busy[-1][1], t)
            else:
                self.busy.append([s, t])
        self.busy_s = sum(t - s for s, t in self.busy) * 1e-9
        self.segments = _segments(spans)
        self._device_ranges(dev)
        self._idle()

    def _device_ranges(self, dev):
        """Each span's device range: from the first start to the last end
        of the operations launched inside it."""
        first = [None] * len(self.names)
        last = [None] * len(self.names)
        starts = [s for s, _, _ in self.segments]
        for s, t, at in dev:
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i < 0 or at >= self.segments[i][1]:
                continue
            for k in self.segments[i][2]:
                first[k] = s if first[k] is None else min(first[k], s)
                last[k] = t if last[k] is None else max(last[k], t)
        self.ranges = [None if a is None else (b - a) * 1e-9
                       for a, b in zip(first, last)]

    def _idle(self):
        self.idle_inner, self.idle_root = {}, {}
        segs, j = self.segments, 0
        for (_, a), (b, _) in zip(self.busy, self.busy[1:]):
            while j < len(segs) and segs[j][1] <= a:
                j += 1
            covered, k = 0, j
            while k < len(segs) and segs[k][0] < b:
                s, t, stack = segs[k]
                part = min(b, t) - max(a, s)
                if part > 0:
                    covered += part
                    self._add_idle(stack, part)
                k += 1
            if b - a > covered:
                self._add_idle((), b - a - covered)

    def _add_idle(self, stack, ns):
        inner = self.names[stack[-1]] if stack else None
        root = self.names[stack[0]] if stack else None
        self.idle_inner[inner] = self.idle_inner.get(inner, 0.0) + ns * 1e-9
        self.idle_root[root] = self.idle_root.get(root, 0.0) + ns * 1e-9

    def device_s(self, name: str):
        """Seconds of the device ranges of all `name` spans, or None when
        none launched anything."""
        found = [r for n, r in zip(self.names, self.ranges)
                 if n == name and r is not None]
        return sum(found) if found else None

    def idle_s(self, names):
        """Device-idle seconds with the host innermost in one of `names`,
        or None when the trace has none of those spans."""
        if not set(names) & set(self.names):
            return None
        return sum(self.idle_inner.get(n, 0.0) for n in names)


def _segments(spans):
    """The host's timeline from the first span's start to the last one's
    end as consecutive (start, end, stack) pieces, `stack` the indices of
    the spans open over the piece, outermost first. Spans on one thread
    nest; `spans` is sorted by start, the longer first."""
    segs, stack, cur = [], [], None

    def cut(t):
        nonlocal cur
        if cur is not None and t > cur:
            segs.append((cur, t, tuple(k for _, k in stack)))
        cur = t if cur is None else max(cur, t)

    for k, (s, t, _) in enumerate(spans):
        while stack and stack[-1][0] <= s:
            cut(stack[-1][0])
            stack.pop()
        cut(s)
        stack.append((t, k))
    while stack:
        cut(stack[-1][0])
        stack.pop()
    return segs


# ---------------------------------------------------------------- readers ---

TOP = {"view": ("eval.render", "requests"), "video": ("video.frame", "frames"),
       "train": ("train.step", "steps")}


def cell_spans(ctx, cell: str):
    """(ProgramSpans of the run's trace, the number of top spans) for the
    cell's kind ("view", "video", "train"), read once a run; None without
    a trace or when the count is not the window's."""
    tr = ctx["trace"]
    if tr is None:
        return None
    top, stat = TOP[cell]
    key = "program_spans." + cell
    if key not in ctx:
        ctx[key] = ProgramSpans(tr.prof, top)
    ps, n = ctx[key], ctx["stats"].get(stat)
    if not n or ps.count != n:
        return None
    return ps, n


def device_ms(ctx, cell: str, names):
    """Mean device ms a top span of the device ranges of `names`."""
    got = cell_spans(ctx, cell)
    if got is None:
        return None
    ps, n = got
    parts = [ps.device_s(name) for name in names]
    found = [p for p in parts if p is not None]
    return 1e3 * sum(found) / n if found else None


def idle_ms(ctx, cell: str, names):
    """Mean device-idle ms a top span with the host innermost in one of
    `names`."""
    got = cell_spans(ctx, cell)
    if got is None:
        return None
    ps, n = got
    s = ps.idle_s(names)
    return None if s is None else 1e3 * s / n


def step_idle_ms(ctx):
    """Mean device-idle ms a step with the host inside `train.step`."""
    got = cell_spans(ctx, "train")
    if got is None:
        return None
    ps, n = got
    return 1e3 * ps.idle_root.get("train.step", 0.0) / n

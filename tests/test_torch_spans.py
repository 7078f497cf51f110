"""The program's spans (`utils/profiling.py` `trace_context`) on the three
paths the benchmark measures, at toy size on the CPU: a view request
(`Evaluator.build_volume` + `render`), a `render_video` frame and one step
of `GeneralizableSystem.fit`. With no profiler running a span enters no
profiler range; under `torch.profiler` each path gives every span it
owns, nested as the layers are; and the outputs are bit-equal with the
profiler on and off. Imports no JAX."""

import pytest
import torch

from torch_parallel_ranks import GEN_PAD, GEN_SAMPLES, \
    generalizable_args, generalizable_sample

HW = 32
CHUNK = 256  # 4 chunks a 32 x 32 image

# (span, its nearest enclosing span) on each path
NESTING = {
    "view": {("eval.volume", None), ("upload", "eval.volume"),
             ("mvsnet.features", "eval.volume"),
             ("mvsnet.sweep", "eval.volume"),
             ("mvsnet.costreg", "eval.volume"),
             ("eval.render", None), ("upload", "eval.render"),
             ("render.sample", "eval.render"),
             ("render.features", "eval.render"),
             ("render.mlp", "eval.render")},
    "video": {("video.frame", None), ("video.rays", "video.frame"),
              ("upload", "video.frame"), ("render.sample", "video.frame"),
              ("render.features", "video.frame"),
              ("render.mlp", "video.frame"),
              ("video.to_host", "video.frame"),
              ("video.panel", "video.frame"),
              ("video.to8b", "video.frame")},
    "train": {("train.step", None), ("upload", "train.step"),
              ("train.draw", "train.step"), ("train.forward", "train.step"),
              ("mvsnet.features", "train.forward"),
              ("mvsnet.sweep", "train.forward"),
              ("mvsnet.costreg", "train.forward"),
              ("render.features", "train.forward"),
              ("render.mlp", "train.forward"),
              ("train.backward", "train.step"),
              ("train.optimizer", "train.step")},
}
TOP = {"view": "eval.render", "video": "video.frame", "train": "train.step"}
PATHS = sorted(NESTING)


class _SourceViews:
    def __init__(self, src):
        self._src = src

    def read_source_views(self):
        return self._src


def _sources(smp):
    return (smp["images"][:3], smp["proj_mats"][:3], smp["near_fars"][0],
            {"w2cs": smp["w2cs"][:3], "intrinsics": smp["intrinsics"][:3]})


def _target_rays(smp):
    from mvsnerf_tpu_torch.data.dtu_ft import rays_for_pose
    k = smp["intrinsics"][3]
    return rays_for_pose(HW, HW, [k[0, 0], k[1, 1]], [k[0, 2], k[1, 2]],
                         smp["c2ws"][3], *smp["near_fars"][3])


def _make(path):
    """fn() running the path once on a system built from the seed; each
    call builds anew, so two calls start from the same state."""
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator
    from mvsnerf_tpu_torch.eval.video import render_video
    from mvsnerf_tpu_torch.train.finetune import FinetuneSystem, \
        seeded_modules
    from mvsnerf_tpu_torch.train.generalizable import GeneralizableSystem
    smp = generalizable_sample(hw=HW)
    args = generalizable_args()

    def view():
        mlp, mvsnet = seeded_modules(args, "cpu")
        ev = Evaluator(mvsnet, mlp, n_samples=GEN_SAMPLES, pad=GEN_PAD,
                       chunk=CHUNK, device="cpu")
        return lambda: dict(
            volume=ev.build_volume(*_sources(smp))[0],
            **ev.render(_target_rays(smp), HW, HW))

    def video():
        system = FinetuneSystem(args, _SourceViews(_sources(smp)),
                                device="cpu")
        kept, render = [], system.render_image

        def keep(rays, chunk):
            kept.append(render(rays, chunk=chunk))
            return kept[-1]

        system.render_image = keep
        k = smp["intrinsics"][3]

        def run():
            frames = render_video(system, smp["c2ws"][3:], HW, HW,
                                  [k[0, 0], k[1, 1]], smp["near_fars"][3],
                                  chunk=CHUNK, with_depth_panel=True)
            return {"frame": torch.from_numpy(frames[0]), **kept[-1]}
        return run

    def train():
        system = GeneralizableSystem(args, device="cpu")

        def run():
            losses = system.fit([smp], num_epochs=1, max_steps=1, seed=5)
            return {"loss": torch.tensor(losses),
                    **{k: v.detach().clone()
                       for k, v in system.mlp.state_dict().items()},
                    **{k: v.detach().clone()
                       for k, v in system.mvsnet.state_dict().items()}}
        return run

    return {"view": view, "video": video, "train": train}[path]()


def _spans(prof):
    """{(span, nearest enclosing span)} of the trace's `mvsnerf.` ranges,
    and the count of each span."""
    pairs, counts = set(), {}
    for e in prof.events():
        if not e.name.startswith("mvsnerf."):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith("mvsnerf."):
            p = p.cpu_parent
        name = e.name[len("mvsnerf."):]
        pairs.add((name, None if p is None else p.name[len("mvsnerf."):]))
        counts[name] = counts.get(name, 0) + 1
    return pairs, counts


_RUNS = {}


def _run(path, on: bool):
    """The path's outputs with the profiler off or on (and then its
    spans), once per module."""
    if (path, on) not in _RUNS:
        run = _make(path)
        if on:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                out = run()
            _RUNS[path, on] = out, _spans(prof)
        else:
            _RUNS[path, on] = run(), None
    return _RUNS[path, on]


@pytest.mark.parametrize("path", PATHS)
def test_spans_enter_nothing_without_a_profiler(monkeypatch, path):
    """With no profiler running, no span makes a profiler range: both
    makers of one raise here (torch's own `autograd.profiler` ranges, such
    as the optimizer's, stay), and the path runs through."""
    from mvsnerf_tpu_torch.utils.profiling import trace_context

    def refuse(*a, **kw):
        raise AssertionError("a profiler range was entered")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    out, _ = _run(path, on=False)
    assert all(torch.isfinite(v.float()).all() for v in out.values())
    # the patch reaches what a span enters once a profiler records
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="profiler range"):
            trace_context("x")


@pytest.mark.parametrize("path", PATHS)
def test_spans_nest_under_the_profiler(path):
    _, (pairs, counts) = _run(path, on=True)
    assert pairs == NESTING[path]
    assert counts[TOP[path]] == 1
    if path != "train":  # 4 chunks: a sample, features and MLP span each
        assert counts["render.mlp"] == counts["render.features"] == 4
        assert counts["render.sample"] == 4


@pytest.mark.parametrize("path", PATHS)
def test_outputs_bit_equal_with_the_profiler_on_and_off(path):
    off, _ = _run(path, on=False)
    on, _ = _run(path, on=True)
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k

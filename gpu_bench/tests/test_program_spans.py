"""The reading of the program's own spans (`gpu_bench/program_spans.py`)
on a made-up trace: a span's device range from the operations launched
inside it, summed over chunks; idle gaps split by overlap among the
host's innermost spans; the top-span count held to the window's; the busy
seconds as `core.Trace` counts them."""

import toy  # noqa: F401
from gpu_bench import core, program_spans
from test_bench_trace import CPU, CUDA, Ev, Prof


class Ev2(Ev):
    """An event with the thread and correlation ids a trace gives."""

    def __init__(self, name, dev, start_ms, dur_ms, corr=0, thread=1):
        super().__init__(name, dev, start_ms, dur_ms)
        self._c, self._th = corr, thread

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0

    def start_thread_id(self):
        return self._th


def span(name, start, dur, thread=1):
    return Ev2("mvsnerf." + name, CPU, start, dur, thread=thread)


def launch(corr, at, start, dur, name="k"):
    """A runtime call on the host at `at` ms and the operation it put on
    the device."""
    return [Ev2("cudaLaunchKernel", CPU, at, 0.01, corr),
            Ev2(name, CUDA, start, dur, corr)]


def request():
    """One view request: two chunks of features then MLP; the device's
    operations 15-25, 35-48, 53-55, 62-66 and 72-95 ms."""
    return [
        Ev2("bench.request", CPU, 0, 100), Ev2("bench.request", CUDA, 15, 80),
        span("eval.render", 0, 100), span("upload", 0, 10),
        span("render.features", 10, 20), span("render.mlp", 30, 20),
        span("render.features", 50, 20), span("render.mlp", 70, 20),
        # a span on another thread is not the program's request
        span("upload", 20, 60, thread=2),
        *launch(1, 12, 15, 10), *launch(2, 31, 35, 13),
        *launch(3, 52, 53, 2), *launch(4, 60, 62, 4),
        *launch(5, 71, 72, 23, name="render_v0_kernel<0, 20>"),
        # an operation no runtime call of the trace launched, at the same
        # interval as another
        Ev2("memset", CUDA, 53, 2, corr=99),
    ]


def ctx(events, requests=1):
    return {"trace": core.Trace(Prof(events)),
            "stats": {"requests": requests, "steps": requests}}


def test_busy_seconds_are_core_traces():
    c = ctx(request())
    ps = program_spans.ProgramSpans(c["trace"].prof, "eval.render")
    assert ps.busy_s == c["trace"].busy_s
    assert abs(ps.busy_s - 0.052) < 1e-12
    assert ps.count == 1


def test_a_gap_is_split_among_spans_by_overlap():
    """The gap 25-35 ms is 5 ms in the first chunk's features and 5 in
    its MLP; 48-53 is 2 in the MLP and 3 in the next features."""
    ps = program_spans.ProgramSpans(Prof(request()), "eval.render")
    ms = {k: round(v * 1e3, 9) for k, v in ps.idle_inner.items()}
    assert ms == {"render.features": 5 + 3 + 7 + 4, "render.mlp": 5 + 2 + 2}
    assert abs(ps.idle_root["eval.render"] - 0.028) < 1e-12
    c = ctx(request())
    assert program_spans.idle_ms(c, "view", ("upload",)) == 0.0
    assert abs(program_spans.idle_ms(c, "view", ("render.mlp",)) - 9) < 1e-9


def test_device_ranges_are_summed_over_chunks():
    """A chunk's features range from its first to its last operation's
    end: 15-25 and 53-66 ms, 23 ms a request."""
    c = ctx(request())
    got = program_spans.device_ms(c, "view", ("render.features",))
    assert abs(got - 23.0) < 1e-9
    both = program_spans.device_ms(c, "view", ("render.features",
                                                "render.mlp"))
    assert abs(both - (23.0 + 13 + 23)) < 1e-9
    assert program_spans.device_ms(c, "view", ("mvsnet.costreg",)) is None


def test_readers_return_none_on_a_count_that_is_not_the_windows():
    assert program_spans.device_ms(ctx(request(), requests=2), "view",
                                   ("render.features",)) is None
    # a program without spans (the parent of the spans) reads nothing
    bare = [e for e in request() if not e.name().startswith("mvsnerf.")]
    assert program_spans.idle_ms(ctx(bare), "view", ("upload",)) is None
    assert program_spans.cell_spans({"trace": None}, "view") is None


def test_step_idle_counts_only_inside_the_step():
    """Idle after `train.step` closed (a segment's end) is not a step's."""
    ev = [span("train.step", 0, 30), span("train.forward", 0, 10),
          span("train.backward", 10, 20), *launch(1, 1, 2, 6),
          *launch(2, 12, 14, 10), *launch(3, 41, 45, 5)]
    c = ctx(ev)
    # idle 8-14 ms inside the step (forward 8-10, backward 10-14), 24-45
    # ms: 24-30 in the step, 30-45 after it
    assert abs(program_spans.step_idle_ms(c) - 12.0) < 1e-9
    ps = c["program_spans.train"]
    assert abs(ps.idle_inner[None] - 0.015) < 1e-12

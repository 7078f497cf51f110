"""Mean device ms of `Evaluator.render` a request, from the profiler's
device range of its span (the chunked renderer: sampling, K4, the volume
fetch, K8); no synchronise."""


def read(ctx):
    tr = ctx["trace"]
    return None if tr is None else tr.span_ms("render")

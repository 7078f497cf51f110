"""Mean device ms of `Evaluator.build_volume` a request, from the
profiler's device range of its span (the sources' upload, MVSNet:
FeatureNet, the K1 sweep, CostRegNet); no synchronise."""


def read(ctx):
    tr = ctx["trace"]
    return None if tr is None else tr.span_ms("build_volume")

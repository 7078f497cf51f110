"""Mean device ms a request of the render's work before its MLP: the
device ranges of the program's `render.sample` (depths, points, NDC) and
`render.features` (view directions, K4's colours, the volume fetch, the
concatenation) spans, summed over the chunks."""
from gpu_bench.program_spans import device_ms


def read(ctx):
    return device_ms(ctx, "view", ("render.sample", "render.features"))

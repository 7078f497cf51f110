"""Mean device-idle ms a request while the host is innermost in the
program's `upload` spans (the sources' and the rays' copies to the
card)."""
from gpu_bench.program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "view", ("upload",))

"""Mean device ms a request of CostRegNet, on whichever route the program
took: the device ranges of the program's `mvsnet.costreg` spans (from the
first to the end of the last operation launched inside each)."""
from gpu_bench.program_spans import device_ms


def read(ctx):
    return device_ms(ctx, "view", ("mvsnet.costreg",))

"""Per cent of the traced window with no operation on the device."""
from gpu_bench.readers import idle_share as read  # noqa: F401

"""Per cent of the f32-equivalent peak reached over the traced window."""
from gpu_bench.readers import mfu as read  # noqa: F401

"""Mean device-idle ms a generalizable step while the host is inside the
program's `train.step` span (idle outside it falls at the ends of the
window's `fit` segments)."""
from gpu_bench.program_spans import step_idle_ms as read  # noqa: F401

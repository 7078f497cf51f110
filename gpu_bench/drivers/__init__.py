"""The benchmark's drivers, one per entry point of the program; a traffic
file names its driver and gives its parameters.

A driver is built with (config, traffic, seed, device) and offers:
setup(spans), window(seconds, spans) -> stats with `attempted` and
`failed`, end_to_end(stats, window_s), release(), check() -> {name:
{value, limit}}, and for the control and fault readings
control_readings(), which compares the reference computed in TF32 with the
float32 reference on the run's own sample, and fault_readings().
"""

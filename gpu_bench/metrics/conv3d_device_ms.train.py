"""Device ms a generalizable step spends in CostRegNet's 3-D
convolutions, forward and backward (cuDNN, or K10 when routed there)."""
from gpu_bench.readers import conv3d_device_ms as read  # noqa: F401

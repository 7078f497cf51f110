"""Per cent of its roofline reached by the render body K8."""
from gpu_bench.readers import k8_roofline as read  # noqa: F401

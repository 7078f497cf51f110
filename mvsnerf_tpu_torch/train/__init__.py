"""See the package docstring of mvsnerf_tpu_torch. The trainers:
`FinetuneSystem`, `FusionFinetuneSystem` and `GeneralizableSystem`."""

from .finetune import FinetuneSystem
from .fusion import FusionFinetuneSystem
from .generalizable import GeneralizableSystem

__all__ = ["FinetuneSystem", "FusionFinetuneSystem", "GeneralizableSystem"]

"""``paddle_tpu_torch.incubate.distributed``: the distributed models
(:mod:`.models`: mixture of experts and expert parallelism)."""
from . import models

__all__ = ["models"]

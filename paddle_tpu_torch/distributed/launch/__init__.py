"""``python -m paddle_tpu_torch.distributed.launch``: one process per rank
(:mod:`.main`)."""
from .main import launch, main

__all__ = ["launch", "main"]

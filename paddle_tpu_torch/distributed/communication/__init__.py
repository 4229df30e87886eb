"""``paddle.distributed.communication``: the ``stream`` namespace."""
from . import stream

__all__ = ["stream"]

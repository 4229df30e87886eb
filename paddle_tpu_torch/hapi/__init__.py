"""The high-level API (the counterpart of ``paddle_tpu/hapi``):
:class:`~.model.Model`, :func:`~.summary.summary`, :func:`~.summary.flops`
and :mod:`.callbacks`."""
from . import callbacks
from .model import LossScalar, Model
from .summary import flops, summary

__all__ = ["Model", "LossScalar", "summary", "flops", "callbacks"]

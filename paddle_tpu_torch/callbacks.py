"""``paddle.callbacks``: the callbacks of :mod:`.hapi.callbacks`."""
from .hapi.callbacks import (Callback, EarlyStopping, LRScheduler,
                             ModelCheckpoint, ProgBarLogger,
                             ReduceLROnPlateau, VisualDL, WandbCallback)

__all__ = ["Callback", "EarlyStopping", "LRScheduler", "ModelCheckpoint",
           "ProgBarLogger", "ReduceLROnPlateau", "VisualDL", "WandbCallback"]

"""The placement rule the port needs from ``paddle_tpu/distributed/auto_parallel``
(:mod:`.spec_layout`): where ZeRO and fsdp put the ``sharding`` axis."""
from .spec_layout import place_axis, spec_axes

__all__ = ["place_axis", "spec_axes"]

"""Mixture of experts and expert parallelism (the counterpart of
``paddle_tpu/incubate/distributed/models/moe/``)."""
from . import functional
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate
from .moe_layer import ExpertMlp, MoELayer, expert_parallel_groups

__all__ = ["BaseGate", "GShardGate", "NaiveGate", "SwitchGate", "ExpertMlp",
           "MoELayer", "expert_parallel_groups", "functional"]

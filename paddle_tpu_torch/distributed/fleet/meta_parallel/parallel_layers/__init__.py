"""The tensor-parallel layers (:mod:`.mp_layers`) and the pipeline
layers (:mod:`.pp_layers`)."""
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "VocabParallelEmbedding", "LayerDesc",
           "PipelineLayer", "SharedLayerDesc"]

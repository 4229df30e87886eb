"""Models of the port: BERT (:mod:`.bert`) and GPT (:mod:`.gpt`).
:func:`params_from_numpy` loads either from the JAX model's weights."""
from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel,
                   BertPretrainingCriterion, bert_base, bert_large,
                   bert_tiny)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion, gpt_13b, gpt_1p3b, gpt_345m,
                  gather_params, gpt_6p7b, gpt_tiny, params_from_numpy,
                  split_axes)

__all__ = ["BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel",
           "BertPretrainingCriterion", "bert_base", "bert_large",
           "bert_tiny", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "GPTPretrainingCriterion", "gpt_345m", "gpt_1p3b", "gpt_6p7b",
           "gpt_13b", "gpt_tiny", "params_from_numpy", "split_axes",
           "gather_params"]

"""Models of the port: GPT (:mod:`.gpt`)."""
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion, gpt_345m, gpt_tiny,
                  params_from_numpy)

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel",
           "GPTPretrainingCriterion", "gpt_345m", "gpt_tiny",
           "params_from_numpy"]

"""Models of the port (``paddle_tpu.models`` counterpart)."""
from paddle_tpu_torch.models.convert import (from_paddle_tpu_params,
                                             optimizer_state_from_paddle_tpu)
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           LlamaPretrainingCriterion,
                                           llama_7b_config,
                                           llama_tiny_config)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaPretrainingCriterion",
           "llama_7b_config", "llama_tiny_config", "from_paddle_tpu_params",
           "optimizer_state_from_paddle_tpu"]

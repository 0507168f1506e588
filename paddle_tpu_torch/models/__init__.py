"""Models of the port (``paddle_tpu.models`` counterpart)."""
from paddle_tpu_torch.models.convert import (from_paddle_tpu_params,
                                             optimizer_state_from_paddle_tpu)
from paddle_tpu_torch.models.gpt_moe import (GptMoeConfig, GptMoeForCausalLM,
                                             gpt_moe_tiny_config)
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           LlamaPretrainingCriterion,
                                           llama_7b_config,
                                           llama_tiny_config)

__all__ = ["GptMoeConfig", "GptMoeForCausalLM", "gpt_moe_tiny_config",
           "LlamaConfig", "LlamaForCausalLM", "LlamaPretrainingCriterion",
           "llama_7b_config", "llama_tiny_config", "from_paddle_tpu_params",
           "optimizer_state_from_paddle_tpu"]

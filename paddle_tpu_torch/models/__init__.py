"""Models of the port (``paddle_tpu.models`` counterpart)."""
from paddle_tpu_torch.models.convert import (fp8_state_from_paddle_tpu,
                                             from_paddle_tpu_params,
                                             gather_expert_params,
                                             gather_paddle_tpu_params,
                                             optimizer_state_from_paddle_tpu,
                                             shard_expert_params,
                                             shard_paddle_tpu_params,
                                             state_from_paddle_tpu)
from paddle_tpu_torch.models.gpt import (GptConfig, GptForCausalLM,
                                         gpt_tiny_config)
from paddle_tpu_torch.models.gpt_moe import (GptMoeConfig, GptMoeForCausalLM,
                                             gpt_moe_tiny_config)
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           LlamaPretrainingCriterion,
                                           llama_7b_config,
                                           llama_tiny_config)

__all__ = ["GptConfig", "GptForCausalLM", "gpt_tiny_config",
           "GptMoeConfig", "GptMoeForCausalLM", "gpt_moe_tiny_config",
           "LlamaConfig", "LlamaForCausalLM", "LlamaPretrainingCriterion",
           "llama_7b_config", "llama_tiny_config", "from_paddle_tpu_params",
           "optimizer_state_from_paddle_tpu", "fp8_state_from_paddle_tpu",
           "state_from_paddle_tpu", "shard_paddle_tpu_params",
           "gather_paddle_tpu_params", "shard_expert_params",
           "gather_expert_params"]

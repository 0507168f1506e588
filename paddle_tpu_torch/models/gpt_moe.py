"""GPT-MoE (``paddle_tpu.models.gpt_moe`` counterpart): a GPT decoder whose
FFN is the MoE layer, with LayerNorm, learned position embeddings and the
LLaMA rotary attention.

Same module tree and parameter names as the JAX package, so
``models.convert.from_paddle_tpu_params`` maps weights one to one.
Attention is the port's ``LlamaAttention`` (flash kernels on CUDA
tensors), built from a ``LlamaConfig`` as the JAX block builds it; the
RoPE tables are one non-persistent buffer pair held by the model. With
``moe_dispatch="dropless"`` the experts run through the grouped-matmul
kernels. ``forward(input_ids, labels)`` returns the logits, or the loss
``cross_entropy + moe_aux_loss_weight * sum of the layers' l_aux``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
from paddle_tpu_torch.models.llama import (LlamaAttention, LlamaConfig,
                                           _rope_tables)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer.norm import LayerNorm

__all__ = ["GptMoeConfig", "GptMoeBlock", "GptMoeForCausalLM",
           "gpt_moe_tiny_config"]


@dataclass
class GptMoeConfig:
    vocab_size: int = 50304
    hidden_size: int = 1024
    num_hidden_layers: int = 12
    num_attention_heads: int = 16
    num_experts: int = 8
    expert_hidden_size: int = 4096
    top_k: int = 2
    max_position_embeddings: int = 2048
    moe_aux_loss_weight: float = 0.01
    dropout: float = 0.0
    # None reads the moe_dispatch flag; "dropless" runs the sort-based
    # ragged dispatch over the grouped-matmul kernels
    moe_dispatch: str | None = None
    # "token" (top-k gates) or "expert" (expert-choice routing)
    moe_router: str = "token"
    # > 0 adds a dense shared-expert MLP to every block
    shared_expert_hidden: int = 0


def gpt_moe_tiny_config(**kw) -> GptMoeConfig:
    cfg = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, num_experts=4, expert_hidden_size=128,
               max_position_embeddings=64)
    cfg.update(kw)
    return GptMoeConfig(**cfg)


def _attn_config(config: GptMoeConfig) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=config.vocab_size, hidden_size=config.hidden_size,
        intermediate_size=config.expert_hidden_size,
        num_hidden_layers=config.num_hidden_layers,
        num_attention_heads=config.num_attention_heads,
        num_key_value_heads=config.num_attention_heads,
        max_position_embeddings=config.max_position_embeddings)


class GptMoeBlock(nn.Module):
    def __init__(self, config: GptMoeConfig, device=None, dtype=None,
                 seed=0):
        super().__init__()
        h = config.hidden_size
        self.ln1 = LayerNorm(h, device=device, dtype=dtype)
        self.attn = LlamaAttention(_attn_config(config), device, dtype)
        self.ln2 = LayerNorm(h, device=device, dtype=dtype)
        self.moe = MoELayer(h, num_expert=config.num_experts,
                            d_hidden=config.expert_hidden_size,
                            top_k=config.top_k, dispatch=config.moe_dispatch,
                            router=config.moe_router,
                            shared_expert_hidden=config.shared_expert_hidden,
                            device=device, dtype=dtype, seed=seed)

    def forward(self, x, rope):
        x = x + self.attn(self.ln1(x), rope)
        return x + self.moe(self.ln2(x))

    @property
    def l_aux(self):
        return self.moe.l_aux


class GptMoeForCausalLM(nn.Module):
    """GPT-MoE with its LM head. ``device`` defaults to "cuda" (raises
    when CUDA is absent); ``dtype`` to fp32. ``seed`` draws the weights
    from a seeded ``torch.Generator`` on the device (N(0, 0.02) for the
    matrices and embeddings, ones and zeros for the LayerNorms, zero
    biases) and seeds each MoE layer's routing generator with seed + 1 +
    its index."""

    def __init__(self, config: GptMoeConfig, device=DEFAULT_DEVICE,
                 dtype=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        dtype = dtype or torch.float32
        self.config = config
        h = config.hidden_size
        self.wte = nn.Embedding(config.vocab_size, h, device=dev, dtype=dtype)
        self.wpe = nn.Embedding(config.max_position_embeddings, h,
                                device=dev, dtype=dtype)
        self.blocks = nn.ModuleList(
            [GptMoeBlock(config, dev, dtype, seed=seed + 1 + i)
             for i in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(h, device=dev, dtype=dtype)
        self.lm_head = nn.Linear(h, config.vocab_size, bias=False,
                                 device=dev, dtype=dtype)
        cos, sin = _rope_tables(h // config.num_attention_heads,
                                config.max_position_embeddings,
                                _attn_config(config).rope_theta, dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def moe_layers(self) -> list[MoELayer]:
        return [blk.moe for blk in self.blocks]

    @torch.no_grad()
    def init_weights(self, seed: int, std: float = 0.02):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith(("ln1.weight", "ln2.weight", "ln_f.weight")):
                p.fill_(1.0)
            elif p.dim() == 1 or name.endswith((".b1", ".b2")):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=gen)
        for i, moe in enumerate(self.moe_layers()):
            moe.manual_seed(seed + 1 + i)

    def forward(self, input_ids, labels=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = self.wte(input_ids) + self.wpe(pos)[None]
        rope = (self.rope_cos, self.rope_sin)
        aux = None
        for blk in self.blocks:
            x = blk(x, rope)
            aux = blk.l_aux if aux is None else aux + blk.l_aux
        logits = self.lm_head(self.ln_f(x))
        if labels is None:
            return logits
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))
        return loss + self.config.moe_aux_loss_weight * aux.to(loss.dtype)

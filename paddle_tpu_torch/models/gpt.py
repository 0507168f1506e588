"""GPT-2-style dense decoder LM on the port's Paddle API
(``paddle_tpu.models.gpt`` counterpart), written as the JAX package writes
it: learned positional embeddings, pre-LN blocks, a gelu MLP and an untied
LM head, from ``nn.Linear`` (weights ``[in, out]``), ``nn.LayerNorm``,
``nn.Embedding``, ``nn.Dropout`` and ``nn.LayerList``. Attention is
``F.scaled_dot_product_attention`` on ``[B, S, H, D]`` views of the packed
QKV projection: the flash kernels on the card (head_dim 64 or 128), their
plain versions on the CPU. The default ``GptConfig`` is GPT-2 small at its
published widths (vocab 50304, hidden 768, 12 layers of 12 heads, MLP
3072, context 1024; about 163M parameters with the untied head). The JAX
model's ``pipeline_layers`` is not ported: the port's ``PipelineLayer``
takes ``torch.nn.Module`` layers (LLaMA's ``pipeline_layers``), and GPT's
stages on the Paddle-API ``Layer`` wait for ROADMAP A6.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F

__all__ = ["GptConfig", "GptForCausalLM", "gpt_tiny_config"]


@dataclass
class GptConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5


def gpt_tiny_config(**kw) -> GptConfig:
    cfg = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=128,
               max_position_embeddings=64)
    cfg.update(kw)
    return GptConfig(**cfg)


class GptAttention(nn.Layer):
    def __init__(self, config: GptConfig):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        self.qkv = nn.Linear(h, 3 * h)
        self.proj = nn.Linear(h, h)

    def forward(self, x):
        B, S, H = x.shape
        packed = self.qkv(x)
        q, k, v = packed.chunk(3, axis=-1)

        def heads(t):
            return t.reshape([B, S, self.num_heads, self.head_dim])

        out = F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                             is_causal=True)
        return self.proj(out.reshape([B, S, H]))


class GptBlock(nn.Layer):
    def __init__(self, config: GptConfig):
        super().__init__()
        h = config.hidden_size
        self.ln1 = nn.LayerNorm(h, epsilon=config.layer_norm_epsilon)
        self.attn = GptAttention(config)
        self.ln2 = nn.LayerNorm(h, epsilon=config.layer_norm_epsilon)
        self.fc1 = nn.Linear(h, config.intermediate_size)
        self.fc2 = nn.Linear(config.intermediate_size, h)
        self.drop = nn.Dropout(config.dropout)

    def forward(self, x):
        x = x + self.drop(self.attn(self.ln1(x)))
        x = x + self.drop(self.fc2(F.gelu(self.fc1(self.ln2(x)))))
        return x


class _GptEmbedding(nn.Layer):
    def __init__(self, config: GptConfig):
        super().__init__()
        self.wte = nn.Embedding(config.vocab_size, config.hidden_size)
        self.wpe = nn.Embedding(config.max_position_embeddings,
                                config.hidden_size)

    def forward(self, input_ids):
        S = input_ids.shape[-1]
        pos = paddle.to_tensor(np.arange(S, dtype=np.int64),
                               place=input_ids.place)
        return self.wte(input_ids) + self.wpe(pos)


class _GptHead(nn.Layer):
    def __init__(self, config: GptConfig):
        super().__init__()
        self.ln_f = nn.LayerNorm(config.hidden_size,
                                 epsilon=config.layer_norm_epsilon)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                 bias_attr=False)

    def forward(self, x):
        return self.lm_head(self.ln_f(x))


class GptForCausalLM(nn.Layer):
    def __init__(self, config: GptConfig):
        super().__init__()
        self.config = config
        self.embed = _GptEmbedding(config)
        self.blocks = nn.LayerList([GptBlock(config)
                                    for _ in range(config.num_hidden_layers)])
        self.head = _GptHead(config)

    def forward(self, input_ids, labels=None):
        x = self.embed(input_ids)
        for blk in self.blocks:
            x = blk(x)
        logits = self.head(x)
        if labels is None:
            return logits
        V = self.config.vocab_size
        return F.cross_entropy(logits[:, :-1].reshape([-1, V]),
                               labels[:, 1:].reshape([-1]))

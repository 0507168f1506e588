"""LLaMA-2 family for training and serving (``paddle_tpu.models.llama``
counterpart).

Same module tree and parameter names as the JAX package, so
``models.convert.from_paddle_tpu_params`` maps weights one to one. The
fleet mp layers (Column/Row/VocabParallel) become plain single-device
``torch.nn.Linear``/``Embedding``: this slice has no tensor parallelism.
Linear weights are PyTorch's ``[out, in]``.

Attention runs the port's hand-written Hopper kernels on CUDA tensors:
prefill and training through the flash kernels (forward, and the dq/dkv
backward under autograd, via ``F.scaled_dot_product_attention``), decode
through the paged kernel. With labels, ``LlamaForCausalLM.forward`` returns
the loss of ``LlamaPretrainingCriterion``; its fused path runs the
hand-written CE statistics kernel and never forms the [tokens, vocab]
logits. CPU tensors take the kernels' plain PyTorch versions.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from paddle_tpu_torch.core.flags import flag
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer.norm import RMSNorm
from paddle_tpu_torch.ops.cuda.paged_attention import paged_attention

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaDecoderLayer", "LlamaPretrainingCriterion",
           "llama_tiny_config", "llama_7b_config", "apply_rotary"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # per-token CE, then the mean over ALL tokens (ignored ones count as
    # 0); False: the mean over the non-ignored tokens
    use_parallel_cross_entropy: bool = True
    dtype: str = "float32"
    # size of the ONE RoPE cos/sin table pair (absolute-position indexed by
    # the decode path); 0 = max_position_embeddings. A position at or past
    # it is a hard error
    rope_max_position: int = 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def llama_7b_config(**overrides) -> LlamaConfig:
    return LlamaConfig(**overrides)


def llama_tiny_config(**overrides) -> LlamaConfig:
    cfg = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=4, max_position_embeddings=128)
    cfg.update(overrides)
    return LlamaConfig(**cfg)


def _rope_tables(head_dim: int, max_pos: int, theta: float, device=None):
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)  # [max_pos, head_dim/2]
    return torch.cos(freqs), torch.sin(freqs)


def _rope_limit(config: LlamaConfig) -> int:
    return int(config.rope_max_position or config.max_position_embeddings)


def _check_positions(position_ids, limit: int):
    """Clear error when a position indexes past the RoPE tables. Only
    host tensors are checked (a device check would synchronise every
    layer); the serving engine checks max_seq_len against the limit at
    construction, and on the card an out-of-range gather faults."""
    if position_ids is None or position_ids.is_cuda or not position_ids.numel():
        return
    mx = int(position_ids.max())
    if mx >= limit:
        raise ValueError(
            f"position {mx} is past the hoisted RoPE table "
            f"(rope_max_position={limit}); raise "
            f"LlamaConfig.rope_max_position (or max_position_embeddings) "
            f"to serve longer contexts")


def apply_rotary(q, k, cos, sin):
    """q, k: [B, S, H, D]; cos/sin: [S, D/2] (shared row positions) or
    [B, S, D/2] (per-row positions). Split-half rotation: the first and
    second halves of the head dim form the rotated pairs."""
    c = cos[None, :, None, :] if cos.dim() == 2 else cos[:, :, None, :]
    s = sin[None, :, None, :] if sin.dim() == 2 else sin[:, :, None, :]

    def rot(x):
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    return rot(q), rot(k)


def _linear(n_in, n_out, device, dtype):
    return nn.Linear(n_in, n_out, bias=False, device=device, dtype=dtype)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.head_dim = config.hidden_size // config.num_attention_heads
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        h = config.hidden_size
        kv = self.num_kv_heads * self.head_dim
        self.q_proj = _linear(h, h, device, dtype)
        self.k_proj = _linear(h, kv, device, dtype)
        self.v_proj = _linear(h, kv, device, dtype)
        self.o_proj = _linear(h, h, device, dtype)
        self._rope_limit = _rope_limit(config)

    def _qkv(self, x):
        b, t, _ = x.shape
        return (self.q_proj(x).view(b, t, -1, self.head_dim),
                self.k_proj(x).view(b, t, -1, self.head_dim),
                self.v_proj(x).view(b, t, -1, self.head_dim))

    def forward(self, x, rope, segment_ids=None, position_ids=None):
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        cos, sin = rope
        limit = self._rope_limit
        _check_positions(position_ids, limit)
        if position_ids is not None:
            # per-row positions (restarting at 0 per packed document)
            c, sn = cos[position_ids], sin[position_ids]
        else:
            if s > limit:
                raise ValueError(
                    f"sequence length {s} is past the hoisted RoPE table "
                    f"(rope_max_position={limit}); raise "
                    f"LlamaConfig.rope_max_position to run longer sequences")
            c, sn = cos[:s], sin[:s]
        q, k = apply_rotary(q, k, c.to(q.dtype), sn.to(q.dtype))
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             training=self.training,
                                             segment_ids=segment_ids)
        return self.o_proj(out.reshape(b, s, -1))

    def forward_decode(self, x, *, rope, cache, layer_idx, page_table,
                       context_lens, position_ids, ctx_pad=None,
                       segment_ids=None):
        """Serving forward over the paged KV cache. x: [B, T, H]; T == 1 is
        a decode step (the paged kernel over the page table); T > 1 is a
        page-writing prefill chunk (the flash kernel over the context
        gathered back from the pages, ``ctx_pad`` rows), or, with
        ``segment_ids`` [B, T], a PACKED multi-prompt prefill frame (the
        segment-aware flash kernel over the frame itself; page_table is
        then [n_segments + 1, pages], one chain per segment plus an
        all-null row for pad/gap tokens, and position_ids are
        segment-local). ``cache`` is {"k", "v": [L, Hkv, P, page_size, D]};
        position_ids [B, T] are absolute positions; context_lens [B]
        counts valid cache tokens including this chunk. Returns
        (out, cache)."""
        b, t, _ = x.shape
        packed = segment_ids is not None and t > 1
        q, k, v = self._qkv(x)
        cos, sin = rope
        _check_positions(position_ids, self._rope_limit)
        q, k = apply_rotary(q, k, cos[position_ids].to(q.dtype),
                            sin[position_ids].to(q.dtype))

        ck, cv = cache["k"][layer_idx], cache["v"][layer_idx]  # [Hkv,P,ps,D]
        ps = ck.shape[2]
        if packed:
            # a token's page chain is its segment's row, its column its
            # segment-local position; pad/gap tokens carry the all-null
            # last row and spill to page 0
            pidx = page_table[segment_ids, position_ids // ps]
        else:
            pidx = torch.gather(page_table, 1, (position_ids // ps).long())
        slot = position_ids % ps
        # in-place pool writes (index_put_ into this layer's view of the
        # pool) where the JAX package runs a functional scatter into pools
        # it donates to XLA
        ck[:, pidx, slot] = k.permute(2, 0, 1, 3).to(ck.dtype)
        cv[:, pidx, slot] = v.permute(2, 0, 1, 3).to(cv.dtype)

        if t == 1:
            out = paged_attention(q[:, 0], ck, cv, page_table,
                                  context_lens)[:, None]
        elif packed:
            # every segment is a fresh prompt whose whole K/V sits in this
            # frame; the round trip through the pool dtype keeps packed
            # outputs equal to sequential chunked prefill
            k_in = k.to(ck.dtype).to(q.dtype)
            v_in = v.to(cv.dtype).to(q.dtype)
            out = F.scaled_dot_product_attention(
                q, k_in, v_in, is_causal=True, training=False,
                segment_ids=segment_ids)
        else:
            # chunked prefill: gather the context back from the pages
            # (they hold this chunk too, written above) and run the flash
            # kernel with the chunk's queries at their absolute rows of a
            # [B, ctx_pad] frame, so the causal mask sees true positions;
            # the other rows are padding whose outputs are dropped
            if ctx_pad is None:
                raise ValueError("prefill chunks need ctx_pad (the padded "
                                 "context bucket)")
            pos_full = torch.arange(ctx_pad, device=x.device)
            pidx_f = page_table[:, pos_full // ps]                # [B, S]
            slot_f = (pos_full % ps).expand(b, ctx_pad)
            k_full = ck[:, pidx_f, slot_f].permute(1, 2, 0, 3).to(q.dtype)
            v_full = cv[:, pidx_f, slot_f].permute(1, 2, 0, 3).to(q.dtype)
            q_full = q.new_zeros((b, ctx_pad) + tuple(q.shape[2:]))
            bidx = torch.arange(b, device=x.device)[:, None]
            q_full[bidx, position_ids] = q
            out_full = F.scaled_dot_product_attention(
                q_full, k_full, v_full, is_causal=True, training=False)
            out = out_full[bidx, position_ids]
        return self.o_proj(out.reshape(b, t, -1)), cache


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(h, m, device, dtype)
        self.up_proj = _linear(h, m, device, dtype)
        self.down_proj = _linear(m, h, device, dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, eps, device, dtype)
        self.self_attn = LlamaAttention(config, device, dtype)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps,
                                                device, dtype)
        self.mlp = LlamaMLP(config, device, dtype)

    def forward(self, x, rope, segment_ids=None, position_ids=None):
        x = x + self.self_attn(self.input_layernorm(x), rope,
                               segment_ids=segment_ids,
                               position_ids=position_ids)
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward_decode(self, x, **kw):
        attn_out, cache = self.self_attn.forward_decode(
            self.input_layernorm(x), **kw)
        x = x + attn_out
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, cache


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, device=device,
                                         dtype=dtype)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device, dtype)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device,
                            dtype)
        # ONE fp32 RoPE table pair for the whole stack, indexed by absolute
        # position on the decode path
        head_dim = config.hidden_size // config.num_attention_heads
        cos, sin = _rope_tables(head_dim, _rope_limit(config),
                                config.rope_theta, device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, input_ids, segment_ids=None, position_ids=None):
        x = self.embed_tokens(input_ids)
        rope = (self.rope_cos, self.rope_sin)
        for layer in self.layers:
            x = layer(x, rope, segment_ids=segment_ids,
                      position_ids=position_ids)
        return self.norm(x)

    def decode_forward(self, input_ids, cache, page_table, context_lens,
                       position_ids, ctx_pad=None, segment_ids=None):
        """Serving forward over the paged KV cache: a decode step when
        input_ids is [B, 1], a page-writing prefill chunk when [B, T > 1],
        a packed multi-prompt prefill frame when [B, T > 1] with
        segment_ids. Returns (hidden, cache); the pools are written in
        place."""
        x = self.embed_tokens(input_ids)
        rope = (self.rope_cos, self.rope_sin)
        for i, layer in enumerate(self.layers):
            x, cache = layer.forward_decode(
                x, rope=rope, cache=cache, layer_idx=i,
                page_table=page_table, context_lens=context_lens,
                position_ids=position_ids, ctx_pad=ctx_pad,
                segment_ids=segment_ids)
        return self.norm(x), cache


class LlamaPretrainingCriterion(nn.Module):
    """Causal-LM loss (paddle_tpu ``LlamaPretrainingCriterion``). With
    ``use_parallel_cross_entropy`` (the default): per-token CE, then the
    mean over ALL tokens, ignored ones counting as 0; without it: the mean
    over the non-ignored tokens. Labels are the next-token targets, already
    shifted by the caller (the packer does it), ``ignore_index`` -100."""

    ignore_index = -100

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.parallel = config.use_parallel_cross_entropy

    def forward(self, logits, labels):
        if self.parallel:
            return F.parallel_cross_entropy(
                logits, labels, ignore_index=self.ignore_index).mean()
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1),
                               ignore_index=self.ignore_index)

    def forward_fused(self, hidden, lm_head, labels):
        """The head projection and the CE in one fused op: the
        [tokens, vocab] logits never exist, and the reduction is this
        criterion's own."""
        reduction = "none" if self.parallel else "mean"
        loss = F.fused_linear_cross_entropy(
            hidden, lm_head.weight, labels, bias=lm_head.bias,
            ignore_index=self.ignore_index, reduction=reduction)
        return loss.mean() if self.parallel else loss


class LlamaForCausalLM(nn.Module):
    """LLaMA with its LM head and loss. ``device`` defaults to "cuda"
    (raises when CUDA is absent); ``dtype`` defaults to ``config.dtype``.
    ``seed`` draws the weights from a seeded ``torch.Generator`` (N(0,
    0.02) for the matrices, ones for the norms) on the target device."""

    def __init__(self, config: LlamaConfig, device=DEFAULT_DEVICE,
                 dtype=None, seed: int | None = None):
        super().__init__()
        dev = resolve_device(device)
        dtype = dtype or config.torch_dtype
        self.config = config
        self.llama = LlamaModel(config, dev, dtype)
        self.lm_head = _linear(config.hidden_size, config.vocab_size, dev,
                               dtype)
        self.criterion = LlamaPretrainingCriterion(config)
        if seed is not None:
            self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int, std: float = 0.02):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        for name, p in self.named_parameters():
            if p.dim() == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=gen)

    def forward(self, input_ids, labels=None, segment_ids=None,
                position_ids=None):
        """Full-sequence logits [B, S, vocab]; with ``labels`` [B, S] the
        scalar loss instead, through the fused head loss unless the
        ``use_fused_head_loss`` flag is off."""
        hidden = self.llama(input_ids, segment_ids=segment_ids,
                            position_ids=position_ids)
        if labels is None:
            return self.lm_head(hidden)
        if flag("use_fused_head_loss"):
            return self.criterion.forward_fused(hidden, self.lm_head, labels)
        return self.criterion(self.lm_head(hidden), labels)

    def decode_forward(self, input_ids, cache, page_table, context_lens,
                       position_ids, ctx_pad=None, segment_ids=None):
        """Serving decode/prefill entry: (logits [B, T, vocab], cache)."""
        hidden, cache = self.llama.decode_forward(
            input_ids, cache, page_table, context_lens, position_ids,
            ctx_pad=ctx_pad, segment_ids=segment_ids)
        return self.lm_head(hidden), cache

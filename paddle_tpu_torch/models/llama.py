"""LLaMA-2 family for training and serving (``paddle_tpu.models.llama``
counterpart).

Same module tree and parameter names as the JAX package, so
``models.convert.from_paddle_tpu_params`` maps weights one to one.
Linear weights are PyTorch's ``[out, in]``. Without tensor parallelism
the seven projections of a layer are `Projection`s (a LoRA adapter's
delta added when one is attached for training or bound by the serving
engine's ``AdapterStore``), the embedding and the head plain
``torch.nn.Embedding``/``Linear``. When the hcg's (or the rank mesh's)
mp degree is above 1 they are the fleet mp layers instead
(``distributed.fleet.layers.mpu.mp_layers``), as in the JAX package: q,
k, v, gate and up ``ColumnParallelLinear``, o and down
``RowParallelLinear``, the embedding ``VocabParallelEmbedding`` and the
head a ``ColumnParallelLinear`` whose vocab shard stays local. The
heads, the kv heads, the intermediate size and the vocabulary split into
contiguous blocks per rank; the fused head loss is the vocab-parallel
one, the logits are gathered over mp. LoRA, fp8 and serving under mp > 1
raise (ROADMAP A8).

Attention runs the port's hand-written Hopper kernels on CUDA tensors:
prefill and training through the flash kernels (forward, and the dq/dkv
backward under autograd, via ``F.scaled_dot_product_attention``), decode
through the paged kernel. With labels, ``LlamaForCausalLM.forward`` returns
the loss of ``LlamaPretrainingCriterion``; its fused path runs the
hand-written CE statistics kernel and never forms the [tokens, vocab]
logits. CPU tensors take the kernels' plain PyTorch versions.

Training follows the JAX package's cooperation protocol
(``parallel.scan_layers``): the model is ``layer_remat_capable``, its layer
loop applies the remat policy of ``current_layer_ctx()`` (else the
``remat_policy`` flag) one decoder layer per region, so the embedding, the
final norm and the fused head never sit in one, and each layer tags its
two residual-stream tensors (``tag_residual``) for ``offload_residuals``.
``scan_group()`` is the homogeneous stack; ``scan_layers`` runs it
unrolled. Under sequence parallelism (a sep group of more than one rank
published by the training step, ``parallel.segments.sep_execution``)
each rank holds a contiguous segment of the sequence: the attention runs
ring attention over the group (``parallel.ring_attention``, the flash
kernels block by block), the RoPE positions without ``position_ids`` are
the segment's global ones, ``r S_local + arange(S_local)``, and the
criterion returns the rank's share of the group's mean loss. Under
ZeRO-3 (a ``shard_info`` in the layer context) the stack runs through
``scan_layers.zero3_layer_loop``. The projections, the
embedding, the norms, ``rope`` and the head go through the
``nn.functional`` seam (AMP casts, fp8); the LM head sits in
``amp.fp8.head_scope``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.amp import apply_seam
from paddle_tpu_torch.amp import fp8 as amp_fp8
from paddle_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from paddle_tpu_torch.core.flags import flag
from paddle_tpu_torch.distributed import collective
from paddle_tpu_torch.distributed.fleet.layers.mpu import mp_layers
from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_ops import (
    _c_concat, _c_identity, mp_group)
from paddle_tpu_torch.lora import seam as lora_seam
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer.norm import TorchRMSNorm
from paddle_tpu_torch.ops.cuda.paged_attention import paged_attention
from paddle_tpu_torch.parallel.ring_attention import RingAttention
from paddle_tpu_torch.parallel.scan_layers import (current_layer_ctx,
                                                   tag_residual,
                                                   unrolled_layer_call,
                                                   zero3_layer_loop)
from paddle_tpu_torch.parallel.segments import (current_segment_ctx,
                                                current_sep_group,
                                                note_sep_loss)
from paddle_tpu_torch.quantization import quantize_kv, raw_bytes

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaDecoderLayer", "LlamaPretrainingCriterion",
           "LlamaEmbeddingStage", "LlamaHeadStage",
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
    # the JAX package's lax.scan over the stack; the port accepts it and
    # runs the same layers unrolled
    scan_layers: bool = False

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


_SHARED_ROPE: dict = {}


def _shared_rope_tables(head_dim: int, max_pos: int, theta: float, device):
    """The process-wide (cos, sin) pair of a geometry on `device`: what a
    decoder layer uses when no ``LlamaModel`` hands it the model's pair (a
    pipeline stage holds lone layers). The JAX package keeps the same
    process-wide cache (``_shared_rope_tables``)."""
    key = (int(head_dim), int(max_pos), float(theta), str(device))
    tables = _SHARED_ROPE.get(key)
    if tables is None:
        tables = _rope_tables(head_dim, max_pos, theta, device)
        _SHARED_ROPE[key] = tables
    return tables


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


def _sep_group():
    """The published sep group when it has more than one rank, else
    None."""
    g = current_sep_group()
    return g if g is not None and g.nranks > 1 else None


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


class Projection(nn.Linear):
    """A bias-free ``nn.Linear`` that consults the LoRA seam (the JAX
    package's ``F.linear`` seam, ``nn/functional/__init__.py:251``): when
    an adapter is attached to its weight or a serving binding covers it,
    the rank-r delta is added in the output dtype. With nothing attached
    or bound the cost is the one ``lora_seam.active()`` branch. The product
    is ``F.linear``'s, the AMP and fp8 seam; an fp8 product takes no LoRA
    delta (JAX's ``F.linear`` returns its fp8 path first)."""

    def forward(self, x):
        y = F.linear(x, self.weight, self.bias)
        if lora_seam.active() and not amp_fp8.linear_fp8_enabled(
                x, self.weight):
            d = lora_seam.delta(self.weight, x)
            if d is not None:
                y = y + d.to(y.dtype)
        return y


def _linear(n_in, n_out, device, dtype):
    return Projection(n_in, n_out, bias=False, device=device, dtype=dtype)


def _mp_degree() -> int:
    g = mp_group()
    return 1 if g is None else g.nranks


def _column(n_in, n_out, device, dtype):
    """A projection whose output features split over mp (a `Projection`
    without tensor parallelism)."""
    if _mp_degree() == 1:
        return _linear(n_in, n_out, device, dtype)
    return mp_layers.ColumnParallelLinear(n_in, n_out, has_bias=False,
                                          gather_output=False, device=device,
                                          dtype=dtype)


def _row(n_in, n_out, device, dtype):
    """A projection whose input features split over mp."""
    if _mp_degree() == 1:
        return _linear(n_in, n_out, device, dtype)
    return mp_layers.RowParallelLinear(n_in, n_out, has_bias=False,
                                       input_is_parallel=True, device=device,
                                       dtype=dtype)


def _per_rank(n: int, what: str) -> int:
    mp = _mp_degree()
    if n % mp:
        raise ValueError(f"{what} {n} is not a multiple of the mp degree "
                         f"{mp}")
    return n // mp


def _embedding(config, device, dtype):
    """The token embedding: ``nn.Embedding``, or ``VocabParallelEmbedding``
    (this rank's vocab rows) under mp."""
    if _mp_degree() == 1:
        return nn.Embedding(config.vocab_size, config.hidden_size,
                            device=device, dtype=dtype)
    return mp_layers.VocabParallelEmbedding(
        config.vocab_size, config.hidden_size, device=device, dtype=dtype)


def _lm_head(config, device, dtype):
    """The LM head: a bias-free ``nn.Linear``, or under mp a
    ``ColumnParallelLinear`` whose vocab shard stays local."""
    if _mp_degree() == 1:
        return nn.Linear(config.hidden_size, config.vocab_size, bias=False,
                         device=device, dtype=dtype)
    return mp_layers.ColumnParallelLinear(
        config.hidden_size, config.vocab_size, has_bias=False,
        gather_output=False, device=device, dtype=dtype)


def write_kv_pages(cache, layer_idx, pidx, slot, k, v):
    """Write K/V ``[B, T, Hkv, D]`` into slots (pidx, slot: ``[B, T]``) of
    layer `layer_idx`'s pools, in place (``index_put_`` into the layer's
    view, where the JAX package runs a functional scatter into pools it
    donates to XLA). Quantized pools (``k_scale`` in the cache) are
    written by quantize-on-write, eager PyTorch as the JAX package leaves
    it to XLA: codes to the pools, per-slot-per-head scales to the fp32
    side pools. Returns ((k codes, k scales), (v codes, v scales)), or
    None for pools in a float dtype."""
    ck, cv = cache["k"][layer_idx], cache["v"][layer_idx]
    if "k_scale" not in cache:
        ck[:, pidx, slot] = k.permute(2, 0, 1, 3).to(ck.dtype)
        cv[:, pidx, slot] = v.permute(2, 0, 1, 3).to(cv.dtype)
        return None
    written = []
    for x, pool, scales in ((k, ck, cache["k_scale"][layer_idx]),
                            (v, cv, cache["v_scale"][layer_idx])):
        codes, sc = quantize_kv(x, pool.dtype)
        raw_bytes(pool)[:, pidx, slot] = raw_bytes(codes).permute(2, 0, 1, 3)
        scales[:, pidx, slot] = sc.permute(2, 0, 1)
        written.append((codes, sc))
    return tuple(written)


def dequantize_kv(codes, scales, dtype):
    """Codes ``[..., D]`` times their scales ``[...]``, both cast to
    `dtype` first: the model dtype, in which the JAX model dequantizes
    prefill K/V (the paged kernel dequantizes in fp32)."""
    return codes.to(dtype) * scales[..., None].to(dtype)


def gather_context(cache, layer_idx, page_table, ctx_pad, dtype):
    """Rows 0..ctx_pad-1 of each page chain of ``page_table [B, pages]``
    gathered back from layer `layer_idx`'s pools: (K, V), each
    ``[B, ctx_pad, Hkv, D]`` in `dtype`, dequantized when the pools hold
    codes (the pools stay quantized)."""
    ps = cache["k"].shape[3]
    pos = torch.arange(ctx_pad, device=page_table.device)
    pidx = page_table[:, pos // ps]                               # [B, S]
    slot = (pos % ps).expand(page_table.shape[0], ctx_pad)
    out = []
    for name in ("k", "v"):
        x = cache[name][layer_idx][:, pidx, slot].permute(1, 2, 0, 3)
        if "k_scale" in cache:
            sc = cache[name + "_scale"][layer_idx][:, pidx, slot]
            out.append(dequantize_kv(x, sc.permute(1, 2, 0), dtype))
        else:
            out.append(x.to(dtype))
    return tuple(out)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.head_dim = config.hidden_size // config.num_attention_heads
        # this rank's heads (all of them without tensor parallelism)
        self.num_heads = _per_rank(config.num_attention_heads, "heads")
        self.num_kv_heads = _per_rank(config.num_key_value_heads,
                                      "kv heads")
        h = config.hidden_size
        kv = config.num_key_value_heads * self.head_dim
        self.q_proj = _column(h, h, device, dtype)
        self.k_proj = _column(h, kv, device, dtype)
        self.v_proj = _column(h, kv, device, dtype)
        self.o_proj = _row(h, h, device, dtype)
        self._rope_limit = _rope_limit(config)

    def _qkv(self, x):
        b, t, _ = x.shape
        return (self.q_proj(x).view(b, t, -1, self.head_dim),
                self.k_proj(x).view(b, t, -1, self.head_dim),
                self.v_proj(x).view(b, t, -1, self.head_dim))

    def forward(self, x, rope=None, segment_ids=None, position_ids=None):
        b, s, _ = x.shape
        if segment_ids is None and position_ids is None:
            # a pipeline stage publishes its microbatch's packed-batch ids
            ctx = current_segment_ctx()
            if ctx is not None:
                segment_ids, position_ids = (ctx.segment_ids,
                                             ctx.position_ids)
        if rope is None:
            rope = _shared_rope_tables(self.head_dim, self._rope_limit,
                                       self.config.rope_theta, x.device)
        q, k, v = self._qkv(x)
        q, k, cos, sin = apply_seam("rope", (q, k) + tuple(rope))
        limit = self._rope_limit
        _check_positions(position_ids, limit)
        sep = _sep_group()
        if position_ids is not None:
            # per-row positions (restarting at 0 per packed document); under
            # sep the step hands each rank its slice of the global ids
            c, sn = cos[position_ids], sin[position_ids]
        else:
            # under sep this rank's rows sit at its segment's global
            # positions
            off = sep.rank * s if sep is not None else 0
            if off + s > limit:
                raise ValueError(
                    f"sequence length {off + s} is past the hoisted RoPE "
                    f"table (rope_max_position={limit}); raise "
                    f"LlamaConfig.rope_max_position to run longer sequences")
            c, sn = cos[off:off + s], sin[off:off + s]
        q, k = apply_rotary(q, k, c.to(q.dtype), sn.to(q.dtype))
        if sep is not None:
            q, k, v = apply_seam("sdpa", (q, k, v))
            out = RingAttention.apply(q, k, v, sep, True, None, segment_ids)
        else:
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 training=self.training,
                                                 segment_ids=segment_ids)
        return self.o_proj(out.reshape(b, s, -1))

    def forward_decode(self, x, *, rope, cache, layer_idx, page_table,
                       context_lens, position_ids, ctx_pad=None,
                       write_mask=None, verify=False, segment_ids=None):
        """Serving forward over the paged KV cache. x: [B, T, H]; T == 1 is
        a decode step (the paged kernel over the page table); T > 1 is a
        page-writing prefill chunk (the flash kernel over the context
        gathered back from the pages, ``ctx_pad`` rows), or, with
        ``segment_ids`` [B, T], a PACKED multi-prompt prefill frame (the
        segment-aware flash kernel over the frame itself; page_table is
        then [n_segments + 1, pages], one chain per segment plus an
        all-null row for pad/gap tokens, and position_ids are
        segment-local), unless ``verify``: the T-token speculative VERIFY
        frame, through the same paged kernel as decode with per-query
        causal limits (query i, at absolute position context_lens - 1 + i,
        sees keys < context_lens + i, the draft K/V written just before
        included). ``cache`` is {"k", "v": [L, Hkv, P, page_size, D]},
        plus {"k_scale", "v_scale": [L, Hkv, P, page_size] fp32} when the
        pools hold int8 or float8_e4m3fn codes: writes then quantize with
        per-slot-per-head absmax scales and reads dequantize (inside the
        paged kernel for decode and verify, in the model dtype for
        prefill); position_ids [B, T] are absolute positions; context_lens
        [B] counts valid cache tokens including this chunk (for verify:
        the committed context and the frame's rewrite token only, the
        drafts are provisional). ``write_mask`` [B, T] bool sends the
        masked entries' K/V writes to the null page 0, which no live
        context reads (a verify frame's slots past a row's draft window,
        budget or context cap; several masked entries may write one slot of
        page 0 at once, harmlessly). Returns (out, cache)."""
        b, t, _ = x.shape
        packed = segment_ids is not None and t > 1 and not verify
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
        if write_mask is not None:
            pidx = torch.where(write_mask, pidx, torch.zeros_like(pidx))
        written = write_kv_pages(cache, layer_idx, pidx, position_ids % ps,
                                 k, v)

        if t == 1 or verify:
            # decode, or the [B, T, Hq, D] verify frame whole: query i sees
            # keys < context_lens + i
            k_sc = cache["k_scale"][layer_idx] if written else None
            v_sc = cache["v_scale"][layer_idx] if written else None
            out = paged_attention(q if verify else q[:, 0], ck, cv,
                                  page_table, context_lens, k_scales=k_sc,
                                  v_scales=v_sc)
            if not verify:
                out = out[:, None]
        elif packed:
            # every segment is a fresh prompt whose whole K/V sits in this
            # frame; the round trip through the pool dtype (and, quantized,
            # the chunked gather's dequant in the model dtype) keeps packed
            # outputs equal to sequential chunked prefill
            if written:
                (kc, sck), (vc, scv) = written
                k_in = dequantize_kv(kc, sck, q.dtype)
                v_in = dequantize_kv(vc, scv, q.dtype)
            else:
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
            k_full, v_full = gather_context(cache, layer_idx, page_table,
                                            ctx_pad, q.dtype)
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
        self.gate_proj = _column(h, m, device, dtype)
        self.up_proj = _column(h, m, device, dtype)
        self.down_proj = _row(m, h, device, dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    # linear weights [out, in]; the JAX package and snapshots: [in, out]
    torch_linear_layout = True

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = TorchRMSNorm(config.hidden_size, eps, device,
                                            dtype)
        self.self_attn = LlamaAttention(config, device, dtype)
        self.post_attention_layernorm = TorchRMSNorm(config.hidden_size,
                                                     eps, device, dtype)
        self.mlp = LlamaMLP(config, device, dtype)

    def forward(self, x, rope=None, segment_ids=None, position_ids=None):
        """`rope` is the model's (cos, sin) pair; None (a lone layer in a
        pipeline stage) takes the process-wide pair of this geometry."""
        x = tag_residual(x + self.self_attn(self.input_layernorm(x), rope,
                                            segment_ids=segment_ids,
                                            position_ids=position_ids))
        return tag_residual(x + self.mlp(self.post_attention_layernorm(x)))

    def forward_decode(self, x, **kw):
        attn_out, cache = self.self_attn.forward_decode(
            self.input_layernorm(x), **kw)
        x = x + attn_out
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, cache


class LlamaModel(nn.Module):
    # the policy of current_layer_ctx() applies per decoder layer
    layer_remat_capable = True

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.embed_tokens = _embedding(config, device, dtype)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device, dtype)
             for _ in range(config.num_hidden_layers)])
        self.norm = TorchRMSNorm(config.hidden_size, config.rms_norm_eps,
                                 device, dtype)
        # ONE fp32 RoPE table pair for the whole stack, indexed by absolute
        # position on the decode path
        head_dim = config.hidden_size // config.num_attention_heads
        cos, sin = _rope_tables(head_dim, _rope_limit(config),
                                config.rope_theta, device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def scan_group(self):
        """The homogeneous decoder stack."""
        return list(self.layers)

    def forward(self, input_ids, segment_ids=None, position_ids=None):
        if isinstance(self.embed_tokens, nn.Embedding):
            x = F.embedding(input_ids, self.embed_tokens.weight)
        else:
            x = self.embed_tokens(input_ids)
        rope = (self.rope_cos, self.rope_sin)
        ctx = current_layer_ctx()
        policy = ctx.policy if ctx is not None else flag("remat_policy")
        kwargs = {"segment_ids": segment_ids, "position_ids": position_ids}
        if ctx is not None and ctx.shard_info is not None:
            x = zero3_layer_loop(list(self.layers), x, (rope,), kwargs,
                                 ctx.shard_info)
            return self.norm(x)
        for layer in self.layers:
            x = unrolled_layer_call(layer, x, (rope,), kwargs, policy)
        return self.norm(x)

    def decode_forward(self, input_ids, cache, page_table, context_lens,
                       position_ids, ctx_pad=None, write_mask=None,
                       verify=False, segment_ids=None):
        """Serving forward over the paged KV cache: a decode step when
        input_ids is [B, 1], a page-writing prefill chunk when [B, T > 1],
        a packed multi-prompt prefill frame when [B, T > 1] with
        segment_ids, a speculative verify frame with ``verify`` (see
        ``LlamaAttention.forward_decode``; ``write_mask`` [B, T] sends
        masked writes to the null page). Returns (hidden, cache); the
        pools are written in place."""
        x = self.embed_tokens(input_ids)
        rope = (self.rope_cos, self.rope_sin)
        for i, layer in enumerate(self.layers):
            x, cache = layer.forward_decode(
                x, rope=rope, cache=cache, layer_idx=i,
                page_table=page_table, context_lens=context_lens,
                position_ids=position_ids, ctx_pad=ctx_pad,
                write_mask=write_mask, verify=verify,
                segment_ids=segment_ids)
        return self.norm(x), cache


class LlamaPretrainingCriterion(nn.Module):
    """Causal-LM loss (paddle_tpu ``LlamaPretrainingCriterion``). With
    ``use_parallel_cross_entropy`` (the default): per-token CE, then the
    mean over ALL tokens, ignored ones counting as 0; without it: the mean
    over the non-ignored tokens. Labels are the next-token targets, already
    shifted by the caller (the packer does it), ``ignore_index`` -100.

    Under sequence parallelism (a published sep group of more than one
    rank) each rank holds a segment of the rows, and its loss is its share
    of the group's mean: its summed per-token loss over the group's
    counted tokens (all of them, or the non-ignored ones, whose count
    takes one all-reduce over the group). The shares sum to the mean over
    the whole rows, whatever the ignored labels' spread over the
    segments. The share is recorded (``segments.note_sep_loss``): a step
    under sep trains only on it."""

    ignore_index = -100

    def __init__(self, config: LlamaConfig, mp_group=None):
        super().__init__()
        self.parallel = config.use_parallel_cross_entropy
        # logits and head weights are this rank's vocab shard when the
        # group has more than one rank
        self.mp_group = mp_group if mp_group is not None and \
            mp_group.nranks > 1 else None

    def _sep_share(self, total, labels, sep):
        """`total`, this rank's summed per-token loss, over the sep
        group's counted tokens."""
        if self.parallel:
            return note_sep_loss(total / (labels.numel() * sep.nranks))
        count = (labels != self.ignore_index).sum().to(torch.float32)
        collective.all_reduce(count, group=sep)
        return note_sep_loss(total / count.clamp_min(1).to(total.dtype))

    def forward(self, logits, labels):
        sep = _sep_group()
        if self.mp_group is not None:
            nll = mp_layers.vocab_parallel_nll(logits, labels, self.mp_group,
                                               self.ignore_index)
            if sep is not None:
                return self._sep_share(nll.sum(), labels, sep)
            if self.parallel:
                return F.mean(nll)
            valid = (labels != self.ignore_index).sum().clamp_min(1)
            return nll.sum() / valid.to(nll.dtype)
        if sep is not None:
            total = (F.parallel_cross_entropy(
                logits, labels, ignore_index=self.ignore_index).sum()
                if self.parallel else F.cross_entropy(
                    logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                    ignore_index=self.ignore_index, reduction="sum"))
            return self._sep_share(total, labels, sep)
        if self.parallel:
            return F.mean(F.parallel_cross_entropy(
                logits, labels, ignore_index=self.ignore_index))
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1),
                               ignore_index=self.ignore_index)

    def forward_fused(self, hidden, lm_head, labels):
        """The head projection and the CE in one fused op: the
        [tokens, vocab] logits never exist, and the reduction is this
        criterion's own."""
        sep = _sep_group()
        if sep is not None:
            total = F.fused_linear_cross_entropy(
                hidden, lm_head.weight, labels, bias=lm_head.bias,
                ignore_index=self.ignore_index, reduction="sum",
                mp_group=self.mp_group)
            return self._sep_share(total, labels, sep)
        reduction = "none" if self.parallel else "mean"
        loss = F.fused_linear_cross_entropy(
            hidden, lm_head.weight, labels, bias=lm_head.bias,
            ignore_index=self.ignore_index, reduction=reduction,
            mp_group=self.mp_group)
        return F.mean(loss) if self.parallel else loss


class LlamaForCausalLM(nn.Module):
    """LLaMA with its LM head and loss. ``device`` defaults to "cuda"
    (raises when CUDA is absent); ``dtype`` defaults to ``config.dtype``.
    ``seed`` draws the weights from a seeded ``torch.Generator`` (N(0,
    0.02) for the matrices, ones for the norms) on the target device."""

    # linear weights [out, in]; the JAX package and snapshots: [in, out]
    torch_linear_layout = True

    layer_remat_capable = True
    # under a published sep group the attention rings over it and the
    # criterion shares the loss (TrainStep and SegmentParallel check it)
    supports_sep = True

    def __init__(self, config: LlamaConfig, device=DEFAULT_DEVICE,
                 dtype=None, seed: int | None = None):
        super().__init__()
        dev = resolve_device(device)
        dtype = dtype or config.torch_dtype
        self.config = config
        self.llama = LlamaModel(config, dev, dtype)
        # not a LoRA target: a plain linear (the vocab shard under mp)
        self.lm_head = _lm_head(config, dev, dtype)
        self.mp_group = getattr(self.lm_head, "group", None)
        self.criterion = LlamaPretrainingCriterion(config, self.mp_group)
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
        with amp_fp8.head_scope():
            if labels is not None and flag("use_fused_head_loss"):
                return self.criterion.forward_fused(hidden, self.lm_head,
                                                    labels)
            if self.mp_group is not None:
                # the vocab shard's logits: the hidden state's gradient
                # sums the mp ranks' parts (identity forward, all-reduce
                # backward, as ColumnParallelLinear's input)
                hidden = _c_identity(hidden, self.mp_group)
            logits = F.linear(hidden, self.lm_head.weight)
            if labels is not None:
                return self.criterion(logits, labels)
            if self.mp_group is not None:
                logits = _c_concat(logits, self.mp_group)
            return logits

    def scan_group(self):
        return self.llama.scan_group()

    def decode_forward(self, input_ids, cache, page_table, context_lens,
                       position_ids, ctx_pad=None, write_mask=None,
                       verify=False, segment_ids=None):
        """Serving decode/prefill/verify entry: (logits [B, T, vocab],
        cache)."""
        if self.mp_group is not None:
            raise NotImplementedError(mp_layers.MP_NOT_PORTED.format(
                what="serving"))
        hidden, cache = self.llama.decode_forward(
            input_ids, cache, page_table, context_lens, position_ids,
            ctx_pad=ctx_pad, write_mask=write_mask, verify=verify,
            segment_ids=segment_ids)
        return self.lm_head(hidden), cache

    # ---- pipeline-parallel factory ----------------------------------------
    @staticmethod
    def pipeline_layers(config: LlamaConfig, loss_fn=None):
        """The ``LayerDesc`` list of a ``PipelineLayer``: the embedding, the
        decoder layers, the final norm with the head. Each layer is built in
        `config`'s dtype, on the ``PipelineLayer``'s device, with the mp
        layers when the mp degree is above 1 (as ``LlamaModel`` builds
        them). `loss_fn` is accepted and unused, as in the JAX package;
        the ``PipelineLayer`` takes the loss."""
        from paddle_tpu_torch.distributed.fleet.meta_parallel import (
            LayerDesc)

        dt = config.torch_dtype
        descs = [LayerDesc(LlamaEmbeddingStage, config, dtype=dt)]
        for _ in range(config.num_hidden_layers):
            descs.append(LayerDesc(LlamaDecoderLayer, config, dtype=dt))
        descs.append(LayerDesc(LlamaHeadStage, config, dtype=dt))
        return descs


class LlamaEmbeddingStage(nn.Module):
    """The first pipeline stage's embedding (JAX ``_EmbeddingStage``):
    ``nn.Embedding``, or ``VocabParallelEmbedding`` under mp."""

    # linear weights [out, in]; the JAX package and snapshots: [in, out]
    torch_linear_layout = True

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.embed_tokens = _embedding(config, device, dtype)

    def forward(self, input_ids):
        if isinstance(self.embed_tokens, nn.Embedding):
            return F.embedding(input_ids, self.embed_tokens.weight)
        return self.embed_tokens(input_ids)


class LlamaHeadStage(nn.Module):
    """The last pipeline stage's final norm and LM head (JAX
    ``_HeadStage``). ``forward_features`` is the fused head protocol
    (``parallel.fused_head``): ``forward(x) ==
    lm_head(forward_features(x))``. Under mp the head is a
    ``ColumnParallelLinear`` whose vocab shard stays local, so ``forward``
    returns this rank's logits shard (``LlamaPretrainingCriterion`` with
    the mp group takes them)."""

    # linear weights [out, in]; the JAX package and snapshots: [in, out]
    torch_linear_layout = True

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.norm = TorchRMSNorm(config.hidden_size, config.rms_norm_eps,
                                 device, dtype)
        self.lm_head = _lm_head(config, device, dtype)

    def forward_features(self, x):
        return self.norm(x)

    def forward(self, x):
        h = self.forward_features(x)
        with amp_fp8.head_scope():
            if isinstance(self.lm_head, nn.Linear):
                return F.linear(h, self.lm_head.weight)
            # the column-parallel layer sums the input gradient over mp
            return self.lm_head(h)


_EmbeddingStage = LlamaEmbeddingStage
_HeadStage = LlamaHeadStage

"""The BERT building blocks the decoder-only LM reuses.

Counterpart of `paddle_tpu.models.bert`, cut to what `TransformerLM`
needs: `BertConfig` and the fused-QKV self-attention `MultiHeadAttention`
with its prefill (``use_cache``) and single-token decode (``cache``)
hooks, dense and f32 paged.  The encoder, heads, cross attention,
chunked/verify attention (C > 1 query rows over a cache) and int8 pools
come with later slices and raise `NotImplementedError` here.

State-dict keys match the JAX package (``qkv_proj.weight`` ...); the
Linear weights are PyTorch's ``[out, in]`` (`models.convert`
transposes the JAX ``[in, out]``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import scaled_dot_product_attention
from ..ops.decode_attention import decode_attention
from ..ops.paged_attention import paged_decode_attention

__all__ = ["BertConfig", "MultiHeadAttention"]


class BertConfig:
    def __init__(
        self,
        vocab_size=30522,
        hidden_size=768,
        num_hidden_layers=12,
        num_attention_heads=12,
        intermediate_size=3072,
        max_position_embeddings=512,
        type_vocab_size=2,
        hidden_dropout_prob=0.1,
        attention_probs_dropout_prob=0.1,
        initializer_range=0.02,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.initializer_range = initializer_range


class MultiHeadAttention(nn.Module):
    """Self-attention over one fused ``[D, 3D]`` QKV projection (Q | K | V
    column order, as `paddle_tpu.models.bert.MultiHeadAttention`)."""

    def __init__(self, cfg, d_model=None, n_head=None, dropout=None,
                 self_attention=False, device=None):
        super().__init__()
        if not self_attention:
            raise NotImplementedError(
                "MultiHeadAttention: only fused-QKV self-attention is "
                "ported; cross attention comes with a later slice")
        d = d_model or cfg.hidden_size
        self.n_head = n_head or cfg.num_attention_heads
        self.d_head = d // self.n_head
        self.qkv_proj = nn.Linear(d, 3 * d, device=device)
        self.out_proj = nn.Linear(d, d, device=device)
        self.dropout = nn.Dropout(
            dropout if dropout is not None
            else cfg.attention_probs_dropout_prob)

    def forward(self, query, causal=False, cache=None, use_cache=False):
        """``use_cache=True`` (prefill): also returns the projected
        ``(k, v)`` as ``[B, S, H, Dh]`` views of the QKV projection.
        ``cache`` (decode): see `_decode_with_cache`."""
        b, s, _ = query.shape
        d = self.n_head * self.d_head
        qkv = self.qkv_proj(query)                           # [B, S, 3D]
        # BSHD views of the Q | K | V columns: the flash kernel reads
        # them through their strides, so no head transpose or copy
        q, k, v = (t.view(b, s, self.n_head, self.d_head)
                   for t in qkv.split(d, dim=2))
        if cache is not None:
            return self._decode_with_cache(q, k, v, cache)
        ctx = scaled_dot_product_attention(
            q, k, v, scale=self.d_head ** -0.5, causal=causal, layout="BSHD")
        out = self.dropout(self.out_proj(ctx.reshape(b, s, d)))
        if use_cache:
            return out, (k, v)
        return out

    def _decode_with_cache(self, q, k, v, cache):
        """Write the new token's K/V, then attend over the cache with
        ``lengths = pos + 1`` (the token sees itself).

        * dense — ``(k_cache, v_cache, pos)``: ``[B, T, H, Dh]`` caches,
          row ``pos`` written (clamped to ``T - 1``, as
          ``dynamic_update_slice`` clamps);
        * paged — ``(k_pool, v_pool, pos, tables, block_size)``:
          ``[NB, bs, H, Dh]`` pools; position p goes to pool block
          ``tables[n, p // bs]``, row ``p % bs``.  Inactive slots have
          all-zero table rows, so their writes land in the garbage
          block 0.

        The caches are updated IN PLACE (the JAX version returns new
        arrays); the same tensors are returned.  Returns ``(out,
        cache arrays)``."""
        b, c_len = q.shape[0], q.shape[1]
        if c_len != 1:
            raise NotImplementedError(
                "attention over a cache with %d query rows (chunked "
                "prefill / speculative verify) is not ported yet" % c_len)
        scale = self.d_head ** -0.5
        q1 = q[:, 0].contiguous()                            # [B, H, Dh]
        k1, v1 = k[:, 0], v[:, 0]
        if len(cache) == 3:                                  # dense
            k_cache, v_cache, pos = cache
            pos = pos.to(device=q.device, dtype=torch.long)
            rows = torch.arange(b, device=q.device)
            p = pos.clamp(0, k_cache.shape[1] - 1)
            k_cache[rows, p] = k1.to(k_cache.dtype)
            v_cache[rows, p] = v1.to(v_cache.dtype)
            ctx = decode_attention(q1, k_cache, v_cache,
                                   (pos + 1).to(torch.int32), scale=scale)
            new_cache = (k_cache, v_cache)
        elif len(cache) == 5:                                # paged
            k_pool, v_pool, pos, tables, bs = cache
            bs = int(bs)
            pos = pos.to(device=q.device, dtype=torch.long)
            tables = tables.to(device=q.device, dtype=torch.int32)
            logical = (pos // bs).clamp(0, tables.shape[1] - 1)
            bi = tables.gather(1, logical[:, None])[:, 0].long()
            off = pos % bs
            k_pool[bi, off] = k1.to(k_pool.dtype)
            v_pool[bi, off] = v1.to(v_pool.dtype)
            ctx = paged_decode_attention(q1, k_pool, v_pool, tables,
                                         (pos + 1).to(torch.int32),
                                         scale=scale)
            new_cache = (k_pool, v_pool)
        else:
            raise NotImplementedError(
                "cache tuple must have 3 (dense) or 5 (paged f32) entries, "
                "got %d (int8 pools are not ported yet)" % len(cache))
        ctxv = ctx.reshape(b, 1, self.n_head * self.d_head)
        return self.dropout(self.out_proj(ctxv)), new_cache

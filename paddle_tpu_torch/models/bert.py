"""BERT/ERNIE-base encoder and pretraining heads, and the blocks the
decoder-only LM reuses.

Counterpart of `paddle_tpu.models.bert`: learned word / position /
token-type embeddings, post-LN encoder layers (fused-QKV self-attention
through the flash kernels, exact-erf gelu FFN), the MLM head over the
masked positions with the decoder tied to the word embeddings, and the
NSP head.  `MultiHeadAttention` also carries the engine's prefill
(``use_cache``) and single-token decode (``cache``) hooks, dense and f32
paged.

The reference's two environment knobs of `bench.py --autotune`:
``PADDLE_TPU_FUSED_FFN=1`` runs the FFN's fc1 + gelu through the
fused-epilogue GEMM (`nn.functional.fused_linear`);
``PADDLE_TPU_BERT_HEAD_LAYOUT=BHSD`` materializes the head transposes
around the flash op (the default BSHD reads strided views, no copy).

Not ported yet, and raising `NotImplementedError`: cross attention,
chunked/verify attention (C > 1 query rows over a cache) and int8 pools
(the rest of the generation engine).

State-dict keys match the JAX package (``bert.encoder.0.attn.qkv_proj
.weight`` ...); the Linear weights are PyTorch's ``[out, in]``
(`models.convert` transposes the JAX ``[in, out]``).  Dropout draws from
the ``generator`` of each `Dropout` module, which `ShardedTrainStep`
seeds from (seed, step).
"""

from __future__ import annotations

import os

import torch
from torch import nn

from ..device import resolve_device
from ..nn.functional import fused_linear
from ..ops import nn_ops
from ..ops.attention import scaled_dot_product_attention
from ..ops.decode_attention import decode_attention
from ..ops.paged_attention import paged_decode_attention

__all__ = ["BertConfig", "BertEmbeddings", "BertForPretraining", "BertModel",
           "Dropout", "LayerNorm", "MultiHeadAttention",
           "TransformerEncoderLayer", "convert_legacy_qkv_state_dict"]


class Dropout(nn.Module):
    """``upscale_in_train`` dropout (`ops.nn_ops.dropout`) drawing its
    keep mask from ``self.generator``: None uses PyTorch's default
    generator of the input's device; `ShardedTrainStep` sets one seeded
    from (seed, step) before each step."""

    def __init__(self, p):
        super().__init__()
        self.p = float(p)
        self.generator = None

    def forward(self, x):
        return nn_ops.dropout(x, self.p, self.generator, self.training)


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm` (eps 1e-5) with the reference's arithmetic: f32
    statistics, the result cast back to the input's dtype
    (`ops.nn_ops.layer_norm`)."""

    def __init__(self, d, device=None):
        super().__init__(d, eps=nn_ops.LN_EPS, device=device)

    def forward(self, x):
        return nn_ops.layer_norm(x, self.weight, self.bias, self.eps)


def _fused_ffn_enabled():
    """``PADDLE_TPU_FUSED_FFN=1`` routes the FFN's fc1 + gelu through the
    fused-epilogue GEMM (`paddle_tpu/models/bert.py:23-29`)."""
    return os.getenv("PADDLE_TPU_FUSED_FFN") == "1"


def _head_layout():
    """``PADDLE_TPU_BERT_HEAD_LAYOUT=BHSD`` materializes the
    [B,S,H,D] <-> [B,H,S,D] transposes around the flash op, the negative
    control of `bench.py --autotune` (`paddle_tpu/models/bert.py:32-44`);
    BSHD, the default, reads strided views of the QKV projection."""
    v = os.getenv("PADDLE_TPU_BERT_HEAD_LAYOUT", "BSHD").upper()
    if v not in ("BSHD", "BHSD"):
        raise ValueError(
            "PADDLE_TPU_BERT_HEAD_LAYOUT must be BSHD or BHSD, got %r"
            % v)
    return v


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

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny():
        """For tests and dry runs."""
        return BertConfig(
            vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


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
        device = resolve_device(device)
        d = d_model or cfg.hidden_size
        self.n_head = n_head or cfg.num_attention_heads
        self.d_head = d // self.n_head
        self.qkv_proj = nn.Linear(d, 3 * d, device=device)
        self.out_proj = nn.Linear(d, d, device=device)
        self.dropout = Dropout(
            dropout if dropout is not None
            else cfg.attention_probs_dropout_prob)

    def forward(self, query, attn_bias=None, causal=False, segment_ids=None,
                cache=None, use_cache=False):
        """``attn_bias``: an additive row bias [B, 1 or H, 1, S] (padding
        masks); ``segment_ids``: [B, S] ids of a packed batch, attention
        confined to equal ids.  ``use_cache=True`` (prefill): also
        returns the projected ``(k, v)`` as ``[B, S, H, Dh]`` views of
        the QKV projection.  ``cache`` (decode): see
        `_decode_with_cache`."""
        b, s, _ = query.shape
        d = self.n_head * self.d_head
        qkv = self.qkv_proj(query)                           # [B, S, 3D]
        # BSHD views of the Q | K | V columns: the flash kernel reads
        # them through their strides, so no head transpose or copy
        q, k, v = (t.view(b, s, self.n_head, self.d_head)
                   for t in qkv.split(d, dim=2))
        if cache is not None:
            return self._decode_with_cache(q, k, v, cache)
        layout = _head_layout()
        qa, ka, va = q, k, v
        if layout == "BHSD":
            qa, ka, va = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ctx = scaled_dot_product_attention(
            qa, ka, va, bias=attn_bias, segment_ids=segment_ids,
            scale=self.d_head ** -0.5, causal=causal, layout=layout)
        if layout == "BHSD":
            ctx = ctx.transpose(1, 2)
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


def _init_linear_and_embedding(module, std):
    """N(0, std) Linear and Embedding weights, zero biases (the JAX
    package's `_winit` and default bias initializer)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                nn.init.normal_(m.weight, 0.0, std)
                if getattr(m, "bias", None) is not None:
                    nn.init.zeros_(m.bias)


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder block (BERT style): ``ln1(x + attn(x))``, then
    ``ln2(h + dropout(fc2(gelu(fc1(h)))))``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        device = resolve_device(device)
        d = cfg.hidden_size
        self.attn = MultiHeadAttention(cfg, self_attention=True,
                                       device=device)
        self.ln1 = LayerNorm(d, device=device)
        self.fc1 = nn.Linear(d, cfg.intermediate_size, device=device)
        self.fc2 = nn.Linear(cfg.intermediate_size, d, device=device)
        self.ln2 = LayerNorm(d, device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, attn_bias=None, segment_ids=None):
        h = self.ln1(x + self.attn(x, attn_bias=attn_bias,
                                   segment_ids=segment_ids))
        if _fused_ffn_enabled():
            # the weights are read at call time, so functional_call's
            # rebinding (ShardedTrainStep) reaches the kernel
            f = self.fc2(fused_linear(h, self.fc1.weight, self.fc1.bias,
                                      activation="gelu"))
        else:
            f = self.fc2(nn_ops.gelu(self.fc1(h)))
        return self.ln2(h + self.dropout(f))


class BertEmbeddings(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        device = resolve_device(device)
        d = cfg.hidden_size
        self.word = nn.Embedding(cfg.vocab_size, d, device=device)
        self.position = nn.Embedding(cfg.max_position_embeddings, d,
                                     device=device)
        self.token_type = nn.Embedding(cfg.type_vocab_size, d, device=device)
        self.ln = LayerNorm(d, device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids, position_ids):
        emb = (self.word(input_ids) + self.position(position_ids)
               + self.token_type(token_type_ids))
        return self.dropout(self.ln(emb))


def convert_legacy_qkv_state_dict(state_dict, target_keys):
    """Fuse pre-fusion checkpoints (separate ``q_proj`` / ``k_proj`` /
    ``v_proj``) into the fused ``qkv_proj`` so old checkpoints keep
    loading, as `paddle_tpu.models.bert.convert_legacy_qkv_state_dict`.
    This package's layout: Linear weights ``[out, in]``, so the three
    are stacked along dim 0 (Q | K | V output columns)."""
    out = dict(state_dict)
    for key in target_keys:
        if not key.endswith("qkv_proj.weight") or key in out:
            continue
        base = key[: -len("qkv_proj.weight")]
        names = [base + p + "_proj." + t for t in ("weight", "bias")
                 for p in ("q", "k", "v")]
        if not all(n in out for n in names):
            continue
        parts = [torch.as_tensor(out.pop(n)) for n in names]
        out[key] = torch.cat(parts[:3], dim=0)
        out[base + "qkv_proj.bias"] = torch.cat(parts[3:], dim=0)
    return out


class _QkvCompatMixin:
    def load_state_dict(self, state_dict, strict=True, assign=False):
        state_dict = convert_legacy_qkv_state_dict(
            state_dict, self.state_dict().keys())
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)


class BertModel(_QkvCompatMixin, nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, device=device)
        self.encoder = nn.ModuleList(
            [TransformerEncoderLayer(cfg, device=device)
             for _ in range(cfg.num_hidden_layers)])
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                device=device)

    def forward(self, input_ids, token_type_ids, position_ids,
                attention_mask=None, segment_ids=None):
        """attention_mask: [B, S] with 1 = attend, 0 = pad, turned into
        the additive row bias ``(m - 1) * 1e4`` for the flash op.
        segment_ids: [B, S] ids of a packed batch (attention stays within
        a segment).  Returns ``(sequence [B, S, D], pooled [B, D])``."""
        attn_bias = None
        if attention_mask is not None:
            m = attention_mask.to(torch.float32)
            attn_bias = ((m - 1.0) * 10000.0)[:, None, None, :]
        h = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.encoder:
            h = layer(h, attn_bias=attn_bias, segment_ids=segment_ids)
        pooled = torch.tanh(self.pooler(h[:, 0]))
        return h, pooled


class BertForPretraining(_QkvCompatMixin, nn.Module):
    """MLM + NSP heads.  ``device=None`` is the card (raises when there is
    none); weights start N(0, initializer_range), biases zero, LayerNorms
    unit, as the JAX package initializes them."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.bert = BertModel(cfg, device=device)
        d = cfg.hidden_size
        self.mlm_transform = nn.Linear(d, d, device=device)
        self.mlm_ln = LayerNorm(d, device=device)
        # the decoder shares the word-embedding matrix (weight tying)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size,
                                                 device=device))
        self.nsp = nn.Linear(d, 2, device=device)
        _init_linear_and_embedding(self, cfg.initializer_range)

    def forward(self, input_ids, token_type_ids, position_ids,
                attention_mask=None, segment_ids=None,
                masked_positions=None):
        """masked_positions: optional [B, P] int positions of the masked
        tokens; the MLM head then runs on those P rows only (the
        reference gathers them before the decoder matmul).  Returns
        ``(mlm logits [B, P or S, V], nsp logits [B, 2])``."""
        seq, pooled = self.bert(input_ids, token_type_ids, position_ids,
                                attention_mask, segment_ids=segment_ids)
        if masked_positions is not None:
            seq = nn_ops.take_along_axis(seq, masked_positions[..., None],
                                         axis=1)
        h = self.mlm_ln(nn_ops.gelu(self.mlm_transform(seq)))
        logits = torch.matmul(h, self.bert.embeddings.word.weight.t())
        logits = logits + self.mlm_bias
        return logits, self.nsp(pooled)

    @staticmethod
    def loss(logits, nsp_logits, mlm_labels, mlm_weights, nsp_labels):
        """Masked-LM loss, weighted by ``mlm_weights`` (1.0 at the masked
        positions) and normalized by their sum, plus the mean NSP loss.
        mlm_labels / mlm_weights: shaped like the logits' leading dims;
        nsp_labels: [B, 1]."""
        vocab = logits.shape[-1]
        mlm = nn_ops.softmax_with_cross_entropy(logits.reshape(-1, vocab),
                                                mlm_labels.reshape(-1, 1))
        w = mlm_weights.reshape(-1, 1)
        mlm = (mlm * w).sum() / (w.sum() + 1e-6)
        nsp = nn_ops.softmax_with_cross_entropy(nsp_logits, nsp_labels).mean()
        return mlm + nsp

"""The WMT Transformer (encoder-decoder), eager: the counterpart of
`paddle_tpu.models.transformer`, with its module names, so the two
``state_dict``s share their keys (``src_emb.word.weight``,
``encoder.{i}.attn.qkv_proj.weight``, ``decoder.{i}.cross_attn.q_proj
.weight``, ``out_proj.weight``, ...; `convert.py` transposes the Linear
weights).

* Pre-LN blocks.  The encoder's self-attention and the decoder's causal
  self-attention (``causal=True``: no materialized mask) run through one
  fused QKV projection, the decoder's cross attention through separate
  q, k and v projections over the encoder's memory under the source
  padding bias (`bert.MultiHeadAttention`): all three reach the flash
  kernels (`ops.attention.scaled_dot_product_attention`: kernel 1
  forward, the backward `_use_fused_bwd` picks), Sq and Sk may differ.
* The FFN is fc1 + relu, fc2, then dropout, unfused as the reference's
  dygraph ``Linear`` is (``mul`` + ``elementwise_add`` + act; no Pallas
  GEMM).
* The embeddings are word · sqrt(d_model) + position, then dropout; the
  tables are looked up by `ops.nn_ops.take` (the reference's
  ``lookup_table``): a bad id gives a NaN row, never a device-side
  assert.
* Every dropout is ``upscale_in_train`` and draws from its `Dropout`'s
  ``generator``, which `ShardedTrainStep` seeds from (seed, step).
* `Transformer.loss` is the label-smoothed soft-label cross entropy
  (``one_hot`` -> ``label_smooth`` -> soft ``softmax_with_cross_entropy``
  -> mean) or, at ``label_smooth_eps=0``, the hard-label one, computed
  in f32 as `ops.nn_ops.softmax_with_cross_entropy` does.

    model = Transformer(TransformerConfig(), device="cpu")
    model.load_state_dict(from_jax_state_dict(init_transformer_params(cfg)))
    logits = model(src_ids, src_pos, tgt_ids, tgt_pos, src_pad_mask)
    loss = model.loss(logits, labels, 0.1)
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nn_ops
from .bert import BertConfig, Dropout, LayerNorm, MultiHeadAttention
from .layers import Embedding

__all__ = ["DecoderLayer", "EncoderLayer", "Transformer",
           "TransformerConfig"]


class TransformerConfig:
    """The reference's ``TransformerConfig`` (Transformer-base on WMT14
    En-De by default: d_model 512, 8 heads, 6 + 6 layers, FFN 2048,
    vocabularies of 32000, dropout 0.1)."""

    def __init__(
        self,
        src_vocab_size=32000,
        tgt_vocab_size=32000,
        d_model=512,
        n_head=8,
        num_encoder_layers=6,
        num_decoder_layers=6,
        d_inner=2048,
        max_length=256,
        dropout=0.1,
    ):
        self.src_vocab_size = src_vocab_size
        self.tgt_vocab_size = tgt_vocab_size
        self.d_model = d_model
        self.n_head = n_head
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.d_inner = d_inner
        self.max_length = max_length
        self.dropout = dropout

    def _bert_cfg(self):
        """The BERT config the shared blocks read (widths, the 0.02
        initializer range, dropout)."""
        return BertConfig(
            vocab_size=self.src_vocab_size,
            hidden_size=self.d_model,
            num_attention_heads=self.n_head,
            intermediate_size=self.d_inner,
            max_position_embeddings=self.max_length,
            hidden_dropout_prob=self.dropout,
            attention_probs_dropout_prob=self.dropout,
        )

    @staticmethod
    def tiny():
        return TransformerConfig(
            src_vocab_size=64, tgt_vocab_size=64, d_model=16, n_head=2,
            num_encoder_layers=2, num_decoder_layers=2, d_inner=32,
            max_length=32, dropout=0.0,
        )


def _attention(cfg, bcfg, self_attention, device):
    return MultiHeadAttention(bcfg, d_model=cfg.d_model, n_head=cfg.n_head,
                              dropout=cfg.dropout,
                              self_attention=self_attention, device=device)


class _FFN(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.fc1 = nn.Linear(cfg.d_model, cfg.d_inner, device=device)
        self.fc2 = nn.Linear(cfg.d_inner, cfg.d_model, device=device)
        self.dropout = Dropout(cfg.dropout, "upscale_in_train")

    def forward(self, x):
        return self.dropout(self.fc2(self.fc1(x).relu_()))


class EncoderLayer(nn.Module):
    """Pre-LN: ``x + attn(ln1(x))``, then ``x + ffn(ln2(x))``."""

    def __init__(self, cfg, bcfg, device=None):
        super().__init__()
        device = resolve_device(device)
        self.ln1 = LayerNorm(cfg.d_model, device=device)
        self.attn = _attention(cfg, bcfg, True, device)
        self.ln2 = LayerNorm(cfg.d_model, device=device)
        self.ffn = _FFN(cfg, device)

    def forward(self, x, attn_bias=None):
        x = x + self.attn(self.ln1(x), attn_bias=attn_bias)
        return x + self.ffn(self.ln2(x))


class DecoderLayer(nn.Module):
    """Pre-LN: causal self-attention, cross attention over the memory
    (``cross_bias``: the source padding bias), the FFN."""

    def __init__(self, cfg, bcfg, device=None):
        super().__init__()
        device = resolve_device(device)
        self.ln1 = LayerNorm(cfg.d_model, device=device)
        self.self_attn = _attention(cfg, bcfg, True, device)
        self.ln2 = LayerNorm(cfg.d_model, device=device)
        self.cross_attn = _attention(cfg, bcfg, False, device)
        self.ln3 = LayerNorm(cfg.d_model, device=device)
        self.ffn = _FFN(cfg, device)

    def forward(self, x, memory, self_bias=None, cross_bias=None):
        x = x + self.self_attn(self.ln1(x), attn_bias=self_bias, causal=True)
        x = x + self.cross_attn(self.ln2(x), key=memory,
                                attn_bias=cross_bias)
        return x + self.ffn(self.ln3(x))


class _Embedder(nn.Module):
    def __init__(self, vocab, cfg, device):
        super().__init__()
        self.word = Embedding(vocab, cfg.d_model, device=device)
        self.pos = Embedding(cfg.max_length, cfg.d_model, device=device)
        self.scale = cfg.d_model ** 0.5
        self.dropout = Dropout(cfg.dropout, "upscale_in_train")

    def forward(self, ids, pos_ids):
        return self.dropout(self.word(ids) * self.scale + self.pos(pos_ids))


class Transformer(nn.Module):
    """The encoder-decoder on int token id tensors ``[B, S]`` (and the
    0 / 1 ``src_pad_mask``) on the model's device: ``forward`` gives
    the logits ``[B, St, tgt_vocab_size]`` in the weights' dtype.
    ``device=None`` is the card (raises when there is none); the weights
    are uninitialized until a ``state_dict`` is loaded
    (`convert.from_jax_state_dict` of the JAX model's, or of
    `convert.init_transformer_params`); the LayerNorms start at 1 / 0."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        bcfg = cfg._bert_cfg()
        self.src_emb = _Embedder(cfg.src_vocab_size, cfg, device)
        self.tgt_emb = _Embedder(cfg.tgt_vocab_size, cfg, device)
        self.encoder = nn.ModuleList(
            [EncoderLayer(cfg, bcfg, device)
             for _ in range(cfg.num_encoder_layers)])
        self.enc_ln = LayerNorm(cfg.d_model, device=device)
        self.decoder = nn.ModuleList(
            [DecoderLayer(cfg, bcfg, device)
             for _ in range(cfg.num_decoder_layers)])
        self.dec_ln = LayerNorm(cfg.d_model, device=device)
        self.out_proj = nn.Linear(cfg.d_model, cfg.tgt_vocab_size,
                                  device=device)

    @staticmethod
    def _pad_bias(pad_mask, q_len=None):
        """pad_mask [B, S]: 1 = token, 0 = pad -> the additive bias
        ``(m - 1) · 10000`` ``[B, 1, 1, S]`` in f32."""
        if pad_mask is None:
            return None
        m = pad_mask.to(torch.float32)
        return ((m - 1.0) * 10000.0)[:, None, None, :]

    def encode(self, src_ids, src_pos, src_pad_mask=None):
        bias = self._pad_bias(src_pad_mask, src_ids.shape[1])
        h = self.src_emb(src_ids, src_pos)
        for layer in self.encoder:
            h = layer(h, attn_bias=bias)
        return self.enc_ln(h)

    def decode(self, tgt_ids, tgt_pos, memory, src_pad_mask=None):
        cross_bias = self._pad_bias(src_pad_mask, tgt_ids.shape[1])
        h = self.tgt_emb(tgt_ids, tgt_pos)
        for layer in self.decoder:
            h = layer(h, memory, cross_bias=cross_bias)
        return self.out_proj(self.dec_ln(h))

    def forward(self, src_ids, src_pos, tgt_ids, tgt_pos, src_pad_mask=None):
        memory = self.encode(src_ids, src_pos, src_pad_mask)
        return self.decode(tgt_ids, tgt_pos, memory, src_pad_mask)

    @staticmethod
    def loss(logits, labels, label_smooth_eps=0.1):
        """The mean token cross entropy of ``logits`` ``[..., V]`` against
        int ``labels`` (the logits' leading shape) smoothed by
        ``label_smooth_eps`` (the one-hot rows, zero for a label outside
        [0, V), times 1 - eps, plus eps / V), or hard-label at 0."""
        vocab = logits.shape[-1]
        flat = logits.reshape(-1, vocab)
        lab = labels.reshape(-1, 1)
        if label_smooth_eps:
            oh = (lab == torch.arange(vocab, device=logits.device)).to(
                torch.float32)
            soft = (1 - label_smooth_eps) * oh + label_smooth_eps / vocab
            loss = nn_ops.softmax_with_cross_entropy(flat, soft,
                                                     soft_label=True)
        else:
            loss = nn_ops.softmax_with_cross_entropy(flat, lab)
        return loss.mean()

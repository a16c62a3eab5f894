"""Decoder-only transformer LM — the model the generation engine serves.

Counterpart of `paddle_tpu.models.transformer_lm`: pre-LN blocks
(LayerNorm eps 1e-5, exact-erf gelu FFN) over the fused-QKV
`MultiHeadAttention`, causal self-attention, tied input/output
embeddings (``logits = h @ word.weight.T``).  Three forward modes:

* ``forward(ids, pos)`` — full causal forward;
* ``forward(..., use_cache=True)`` — prefill: the same math through the
  flash kernel, also returning every layer's ``(k, v)`` ``[B, S, H, Dh]``;
* ``forward(..., caches=..., cache_positions=pos)`` — decode: one token
  per row, K/V written into the cache stacks at ``pos`` (in place) and
  attention over the cache through the decode kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .bert import BertConfig, MultiHeadAttention

__all__ = ["TransformerLM", "TransformerLMBlock", "TransformerLMConfig"]

LN_EPS = 1e-5


class TransformerLMConfig:
    def __init__(
        self,
        vocab_size=32000,
        hidden_size=768,
        num_layers=12,
        num_heads=12,
        intermediate_size=3072,
        max_position_embeddings=1024,
        dropout=0.1,
        initializer_range=0.02,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.dropout = dropout
        self.initializer_range = initializer_range

    @staticmethod
    def tiny():
        """For tests, CPU smoke runs, and dry runs."""
        return TransformerLMConfig(
            vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=128,
            dropout=0.0)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    def _bert_cfg(self):
        """Adapter so the shared BERT blocks read their hyperparams."""
        return BertConfig(
            vocab_size=self.vocab_size,
            hidden_size=self.hidden_size,
            num_attention_heads=self.num_heads,
            intermediate_size=self.intermediate_size,
            max_position_embeddings=self.max_position_embeddings,
            hidden_dropout_prob=self.dropout,
            attention_probs_dropout_prob=self.dropout,
            initializer_range=self.initializer_range,
        )


class TransformerLMBlock(nn.Module):
    """Pre-LN decoder block: causal self-attention + gelu FFN."""

    def __init__(self, cfg: TransformerLMConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        bcfg = cfg._bert_cfg()
        d = cfg.hidden_size
        self.ln1 = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self.attn = MultiHeadAttention(bcfg, self_attention=True,
                                       device=device)
        self.ln2 = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self.fc1 = nn.Linear(d, cfg.intermediate_size, device=device)
        self.fc2 = nn.Linear(cfg.intermediate_size, d, device=device)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, x, cache=None, use_cache=False):
        a = self.attn(self.ln1(x), causal=cache is None, cache=cache,
                      use_cache=use_cache)
        kv = None
        if use_cache or cache is not None:
            a, kv = a
        x = x + a
        f = self.fc2(F.gelu(self.fc1(self.ln2(x))))
        x = x + self.dropout(f)
        return (x, kv) if kv is not None else x


class TransformerLM(nn.Module):
    """See module docstring.  ``device=None`` is the card (raises when
    there is none); weights start N(0, initializer_range), biases zero,
    LayerNorms unit — load real ones with ``load_state_dict``."""

    def __init__(self, cfg: TransformerLMConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.word = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                 device=device)
        self.position = nn.Embedding(cfg.max_position_embeddings,
                                     cfg.hidden_size, device=device)
        self.dropout = nn.Dropout(cfg.dropout)
        self.blocks = nn.ModuleList(
            [TransformerLMBlock(cfg, device=device)
             for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS, device=device)
        self._reset_parameters()

    @torch.no_grad()
    def _reset_parameters(self):
        std = self.cfg.initializer_range
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                nn.init.normal_(m.weight, 0.0, std)
                if getattr(m, "bias", None) is not None:
                    nn.init.zeros_(m.bias)

    @property
    def device(self):
        return self.word.weight.device

    def forward(self, input_ids, position_ids, caches=None,
                cache_positions=None, use_cache=False, block_tables=None,
                block_size=None):
        """input_ids/position_ids: [B, S] int.  With ``caches`` (decode:
        one token per row written at ``cache_positions``) the return is
        ``(logits [B, 1, V], cache stacks)``; with ``use_cache=True``
        (prefill) it is ``(logits, [(k, v), ...])`` per layer; otherwise
        just ``logits [B, S, V]``.

        ``caches`` is dense ``(k_stack, v_stack)`` of ``[L, B, T, H, Dh]``,
        or — when ``block_tables`` ``[B, max_blocks]`` and ``block_size``
        are given — a paged ``[L, NB, bs, H, Dh]`` pool pair.  The stacks
        are updated in place and returned."""
        h = self.dropout(self.word(input_ids) + self.position(position_ids))
        new_kv = []
        if caches is not None:
            for li, block in enumerate(self.blocks):
                per_layer = tuple(c[li] for c in caches)
                if block_tables is None:
                    cache = per_layer + (cache_positions,)
                else:
                    cache = per_layer + (cache_positions, block_tables,
                                         block_size)
                h, _ = block(h, cache=cache)
        else:
            for block in self.blocks:
                if use_cache:
                    h, kv = block(h, use_cache=True)
                    new_kv.append(kv)
                else:
                    h = block(h)
        h = self.ln_f(h)
        logits = torch.matmul(h, self.word.weight.t())
        if caches is not None:
            return logits, tuple(caches)
        if use_cache:
            return logits, new_kv
        return logits

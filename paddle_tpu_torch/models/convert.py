"""Parameters across the two packages, and seeded weights with no JAX.

The JAX package's ``state_dict`` and this package's share their keys
(``word.weight``, ``blocks.{i}.attn.qkv_proj.weight``, ...).  The one
difference is the Linear weight: JAX stores ``[in, out]``, `nn.Linear`
``[out, in]``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_state_dict", "init_bert_params", "init_params"]

# every Linear of the two model families (BERT's heads, the LM's blocks,
# and the separate projections of pre-fusion BERT checkpoints)
_LINEARS = ("qkv_proj", "q_proj", "k_proj", "v_proj", "out_proj", "fc1",
            "fc2", "pooler", "mlm_transform", "nsp")


def _is_linear_weight(key):
    parts = key.split(".")
    return len(parts) >= 2 and parts[-1] == "weight" and parts[-2] in _LINEARS


def from_jax_state_dict(np_dict):
    """JAX-layout parameters (numpy arrays, or anything `np.asarray`
    takes) -> a `load_state_dict`-ready dict of CPU tensors."""
    out = {}
    for key, val in np_dict.items():
        arr = np.asarray(val)
        if _is_linear_weight(key):
            arr = arr.T
        out[key] = torch.from_numpy(np.array(arr, order="C", copy=True))
    return out


class _Init:
    """Seeded JAX-layout parameter makers: N(0, std) weights and
    embeddings, zero biases, unit LayerNorm scales, numpy float32."""

    def __init__(self, seed, std, d):
        self.rng = np.random.default_rng(seed)
        self.std, self.d = np.float32(std), d

    def normal(self, *shape):
        return self.rng.standard_normal(shape, dtype=np.float32) * self.std

    def ln(self, prefix):
        return {prefix + ".weight": np.ones(self.d, np.float32),
                prefix + ".bias": np.zeros(self.d, np.float32)}

    def linear(self, prefix, n_in, n_out):
        return {prefix + ".weight": self.normal(n_in, n_out),
                prefix + ".bias": np.zeros(n_out, np.float32)}


def init_params(cfg, seed=0):
    """`TransformerLM` parameters in the JAX layout, as numpy float32:
    N(0, ``cfg.initializer_range``) weights and embeddings, zero biases,
    unit LayerNorm scales.  Made from ``seed`` alone, so the chip smoke
    builds full-width weights with no JAX present."""
    d, f = cfg.hidden_size, cfg.intermediate_size
    init = _Init(seed, cfg.initializer_range, d)
    normal, ln, linear = init.normal, init.ln, init.linear
    p = {"word.weight": normal(cfg.vocab_size, d),
         "position.weight": normal(cfg.max_position_embeddings, d)}
    for i in range(cfg.num_layers):
        b = "blocks.%d." % i
        p.update(ln(b + "ln1"))
        p.update(linear(b + "attn.qkv_proj", d, 3 * d))
        p.update(linear(b + "attn.out_proj", d, d))
        p.update(ln(b + "ln2"))
        p.update(linear(b + "fc1", d, f))
        p.update(linear(b + "fc2", f, d))
    p.update(ln("ln_f"))
    return p


def init_bert_params(cfg, seed=0):
    """`BertForPretraining` parameters in the JAX layout (the keys of
    `paddle_tpu.models.BertForPretraining.state_dict`), as numpy
    float32, initialized as `init_params` does (``mlm_bias`` zero).  Made
    from ``seed`` alone, with no JAX."""
    d, f = cfg.hidden_size, cfg.intermediate_size
    init = _Init(seed, cfg.initializer_range, d)
    e = "bert.embeddings."
    p = {"mlm_bias": np.zeros(cfg.vocab_size, np.float32),
         e + "word.weight": init.normal(cfg.vocab_size, d),
         e + "position.weight": init.normal(cfg.max_position_embeddings, d),
         e + "token_type.weight": init.normal(cfg.type_vocab_size, d)}
    p.update(init.ln(e + "ln"))
    for i in range(cfg.num_hidden_layers):
        b = "bert.encoder.%d." % i
        p.update(init.linear(b + "attn.qkv_proj", d, 3 * d))
        p.update(init.linear(b + "attn.out_proj", d, d))
        p.update(init.ln(b + "ln1"))
        p.update(init.linear(b + "fc1", d, f))
        p.update(init.linear(b + "fc2", f, d))
        p.update(init.ln(b + "ln2"))
    p.update(init.linear("bert.pooler", d, d))
    p.update(init.linear("mlm_transform", d, d))
    p.update(init.ln("mlm_ln"))
    p.update(init.linear("nsp", d, 2))
    return p

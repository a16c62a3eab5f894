"""Parameters across the two packages, and seeded weights with no JAX.

The JAX package's ``state_dict`` and this package's share their keys
(``word.weight``, ``blocks.{i}.attn.qkv_proj.weight``, ...).  The one
difference is the Linear weight: JAX stores ``[in, out]``, `nn.Linear`
``[out, in]``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_state_dict", "init_params"]

_LINEARS = ("qkv_proj", "out_proj", "fc1", "fc2")


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


def init_params(cfg, seed=0):
    """`TransformerLM` parameters in the JAX layout, as numpy float32:
    N(0, ``cfg.initializer_range``) weights and embeddings, zero biases,
    unit LayerNorm scales.  Made from ``seed`` alone, so the chip smoke
    builds full-width weights with no JAX present."""
    rng = np.random.default_rng(seed)
    std = float(cfg.initializer_range)
    d, f = cfg.hidden_size, cfg.intermediate_size

    def normal(*shape):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    def ln(prefix):
        return {prefix + ".weight": np.ones(d, np.float32),
                prefix + ".bias": np.zeros(d, np.float32)}

    def linear(prefix, n_in, n_out):
        return {prefix + ".weight": normal(n_in, n_out),
                prefix + ".bias": np.zeros(n_out, np.float32)}

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

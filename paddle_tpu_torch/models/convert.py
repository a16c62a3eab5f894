"""Parameters across the two packages, and seeded weights with no JAX.

The JAX package's ``state_dict`` and this package's share their keys
(``word.weight``, ``blocks.{i}.attn.qkv_proj.weight``,
``blocks.{i}.conv0._bn._mean``, ...).  The one difference is the Linear
weight: JAX stores ``[in, out]``, `nn.Linear` ``[out, in]``.  Conv
weights (OIHW in both) and BatchNorm vectors land as they are.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_state_dict", "init_bert_params", "init_params",
           "init_resnet_params", "train_state_from_jax"]

# every Linear of the model families (BERT's heads, the LM's blocks, the
# separate projections of pre-fusion BERT checkpoints, ResNet's fc)
_LINEARS = ("qkv_proj", "q_proj", "k_proj", "v_proj", "out_proj", "fc1",
            "fc2", "pooler", "mlm_transform", "nsp", "fc")


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


def train_state_from_jax(model, jax_state):
    """A JAX `ShardedTrainStep` state (``{"params", "opt", "step"}``, its
    arrays anything `np.asarray` takes) as the port's step state for
    ``model``: the entries that are the model's parameters go to
    ``params`` and their optimizer slots to ``opt``, the others (the
    running statistics, which the reference keeps in ``params``) to
    ``buffers``; each laid out, typed and placed as the model's own
    tensor, Linear weights and their slots transposed."""
    own = dict(model.named_parameters())
    bufs = dict(model.named_buffers())
    jp = jax_state["params"]

    def like(ref, key, val, dtype=None):
        return torch.empty_like(ref, dtype=dtype).copy_(
            from_jax_state_dict({key: val})[key])

    def slot(k, v):
        if np.shape(v) == np.shape(jp[k]):      # shaped like the parameter
            return like(own[k], k, v, torch.float32)
        return torch.tensor(np.asarray(v), dtype=torch.float32,
                            device=own[k].device)

    return {"params": {k: like(own[k], k, v) for k, v in jp.items()
                       if k in own},
            "buffers": {k: like(bufs[k], k, v) for k, v in jp.items()
                        if k in bufs},
            "opt": {k: {name: slot(k, v) for name, v in slots.items()}
                    for k, slots in jax_state["opt"].items() if k in own},
            "step": int(np.asarray(jax_state["step"]))}


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


def init_resnet_params(depth=50, num_classes=1000, seed=0, in_channels=3,
                       bn_stats="unit"):
    """`ResNet` parameters in the JAX layout (the keys of
    `paddle_tpu.models.ResNet(depth, num_classes).state_dict`), as numpy
    float32, made from ``seed`` alone with no JAX: conv weights N(0,
    sqrt(2 / fan_in)) as `fluid/dygraph/nn.py:60` Conv2D draws them, the
    fc U(±1/sqrt(in)) with a zero bias.  BatchNorm: ``bn_stats="unit"``
    gives gamma 1, beta 0, mean 0, var 1 (the reference's init);
    ``"random"`` gives seeded non-trivial values (gamma U(0.5, 1.5),
    beta N(0, 0.1), mean N(0, 0.1), var U(0.5, 2)), so a BN fold that
    drops a term shows.  The keys and shapes are the port's model's,
    built on the meta device."""
    from .resnet import ResNet

    if bn_stats not in ("unit", "random"):
        raise ValueError("bn_stats must be 'unit' or 'random', got %r"
                         % (bn_stats,))
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in ResNet(
        depth, num_classes, in_channels, device="meta").state_dict().items()}
    unit = {"weight": np.ones, "bias": np.zeros, "_mean": np.zeros,
            "_variance": np.ones}
    drawn = {"weight": lambda n: rng.uniform(0.5, 1.5, n),
             "bias": lambda n: rng.standard_normal(n) * 0.1,
             "_mean": lambda n: rng.standard_normal(n) * 0.1,
             "_variance": lambda n: rng.uniform(0.5, 2.0, n)}
    p = {}
    for key, shape in shapes.items():
        name = key.rsplit(".", 1)[1]
        if key.endswith("._conv.weight"):
            std = np.sqrt(2.0 / np.prod(shape[1:]))
            val = rng.standard_normal(shape) * std
        elif "._bn." in key:
            val = (unit if bn_stats == "unit" else drawn)[name](shape[0])
        elif key == "fc.weight":     # the JAX Linear's [in, out]
            bound = 1.0 / np.sqrt(shape[1])
            val = rng.uniform(-bound, bound, shape[::-1])
        else:                        # fc.bias
            val = np.zeros(shape)
        p[key] = val.astype(np.float32)
    return p

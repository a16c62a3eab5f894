"""Random initializer ops: gaussian_random, uniform_random.

Counterpart of `paddle_tpu/fluid/ops/random_ops.py` (gaussian_random
:33, uniform_random :44).  A nonzero ``seed`` attr gives the op a
`torch.Generator` of its own (a reproducible op, the reference's
semantics); otherwise it draws from the run's generator (`ctx.rng()`).
Draws are in f32, then cast, as in the reference.  Torch's Philox and
mt19937 are not JAX's threefry, so the values differ from the
reference's; their law does not.
"""

import torch

from ..core.dtypes import to_torch
from ..core.registry import register_op


def _generator(ctx, attrs):
    seed = int(attrs.get("seed", 0))
    if seed:
        return torch.Generator(device=ctx.device).manual_seed(seed)
    return ctx.rng()


def _draw(ctx, attrs, sample, affine):
    """``affine(sample(shape))`` drawn in f32, cast to the op's dtype (an
    empty meta tensor during shape inference)."""
    shape = tuple(attrs["shape"])
    dtype = to_torch(attrs.get("dtype", "float32"))
    if ctx.is_meta:
        return torch.empty(shape, dtype=dtype, device="meta")
    u = sample(shape, generator=_generator(ctx, attrs), dtype=torch.float32,
               device=ctx.device)
    return affine(u).to(dtype)


@register_op("gaussian_random", inputs=[], outputs=["Out"], grad=None,
             needs_rng=True)
def _gaussian_random(ctx, ins, attrs):
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    return {"Out": [_draw(ctx, attrs, torch.randn, lambda z: mean + std * z)]}


@register_op("uniform_random", inputs=[], outputs=["Out"], grad=None,
             needs_rng=True)
def _uniform_random(ctx, ins, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    return {"Out": [_draw(ctx, attrs, torch.rand,
                          lambda u: lo + (hi - lo) * u)]}

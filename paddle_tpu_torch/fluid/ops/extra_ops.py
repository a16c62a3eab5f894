"""Breadth ops beyond the core: the activation extras, logsumexp, roll,
flip, broadcast_to, take_along_axis, kldiv_loss, label_smooth, cos_sim,
instance_norm, affine_grid, grid_sampler and pixel_shuffle.

Counterpart of `paddle_tpu/fluid/ops/extra_ops.py` (the unary table
:33-, logsumexp :96, roll :116, flip :131, broadcast_to :141,
take_along_axis :153, kldiv_loss :276, label_smooth :297, cos_sim :322,
instance_norm :377, affine_grid :481, grid_sampler :499, pixel_shuffle
:582; cf. Paddle's activation_op.cc full registry, roll_op.cc,
flip_op.cc, expand_v2_op.cc, kldiv_loss_op.cc, label_smooth_op.cc,
cos_sim_op.cc, instance_norm_op.cc, affine_grid_op.cc,
grid_sampler_op.cc, pixel_shuffle_op.cc).  Each op is one PyTorch
lowering, as the reference's is one jnp
lowering; ``grid_sampler`` is ``F.grid_sample`` (zero padding per
corner, either ``align_corners`` form), which samples as the
reference's four gathers do.
"""

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .math_ops import softplus, const_like

# ---------------------------------------------------------------------------
# activation extras (cf. activation_op.cc full registry)
# ---------------------------------------------------------------------------

# jax.nn.selu's constants
_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def _selu(x):
    neg = _SELU_ALPHA * torch.expm1(torch.where(x > 0, 0.0, x))
    return _SELU_SCALE * torch.where(x > 0, x, neg)


_UNARY = {
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tan": torch.tan,
    "asin": torch.asin,
    "acos": torch.acos,
    "atan": torch.atan,
    "asinh": torch.asinh,
    "acosh": torch.acosh,
    "atanh": torch.atanh,
    "expm1": torch.expm1,
    "log1p": torch.log1p,
    "log2": torch.log2,
    "log10": torch.log10,
    "lgamma": torch.lgamma,
    "digamma": torch.digamma,
    "erfinv": torch.erfinv,
    "trunc": torch.trunc,
    "frac": lambda x: x - torch.trunc(x),
    "tanh_shrink": lambda x: x - torch.tanh(x),
    "mish": lambda x: x * torch.tanh(softplus(x)),
    "selu": _selu,
    "erfc": torch.erfc,
}


def _register_unary(name, fn):
    @register_op(name, inputs=["X"], outputs=["Out"])
    def _lower(ctx, ins, attrs, fn=fn):
        return {"Out": [fn(ins["X"][0])]}


for _name, _fn in _UNARY.items():
    _register_unary(_name, _fn)


@register_op("logsumexp", inputs=["X"], outputs=["Out"])
def _logsumexp(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis")
    if axis is None:
        dims = tuple(range(x.dim()))
    elif isinstance(axis, (list, tuple)):
        dims = tuple(axis)
    else:
        dims = (axis,)
    return {"Out": [torch.logsumexp(x, dim=dims,
                                    keepdim=bool(attrs.get("keepdim",
                                                           False)))]}


# ---------------------------------------------------------------------------
# manipulation
# ---------------------------------------------------------------------------


@register_op("roll", inputs=["X"], outputs=["Out"])
def _roll(ctx, ins, attrs):
    x = ins["X"][0]
    shifts = attrs["shifts"]
    axis = attrs.get("axis")
    if axis is None or axis == []:
        if len(shifts) != 1:
            raise ValueError(
                "roll: %d shifts but no axis — pass one axis per shift"
                % len(shifts))
        return {"Out": [torch.roll(x.reshape(-1), shifts[0]).reshape(
            x.shape)]}
    return {"Out": [torch.roll(x, tuple(shifts), tuple(axis))]}


@register_op("flip", inputs=["X"], outputs=["Out"])
def _flip(ctx, ins, attrs):
    return {"Out": [torch.flip(ins["X"][0], tuple(attrs["axis"]))]}


@register_op("broadcast_to", inputs=["X"], outputs=["Out"])
def _broadcast_to(ctx, ins, attrs):
    return {"Out": [torch.broadcast_to(ins["X"][0],
                                       tuple(attrs["shape"])).contiguous()]}


@register_op("take_along_axis", inputs=["Input", "Index"],
             outputs=["Result"], no_grad_slots=("Index",))
def _take_along_axis(ctx, ins, attrs):
    """``Input`` gathered along ``Axis`` at ``Index``, the index's size-1
    dims broadcast against the input's."""
    return {"Result": [torch.take_along_dim(
        ins["Input"][0], ins["Index"][0].long(), dim=int(attrs["Axis"]))]}


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@register_op("kldiv_loss", inputs=["X", "Target"], outputs=["Loss"])
def _kldiv_loss(ctx, ins, attrs):
    """X is a log-probability (the reference's semantics); the target's
    log is taken of max(t, 1e-10), a tie passing half its gradient as
    ``jnp.maximum``'s."""
    x, t = ins["X"][0], ins["Target"][0]
    loss = t * (torch.log(torch.maximum(t, const_like(t, 1e-10))) - x)
    red = attrs.get("reduction", "mean")
    if red == "mean":
        return {"Loss": [torch.mean(loss)]}
    if red == "sum":
        return {"Loss": [torch.sum(loss)]}
    if red == "batchmean":
        return {"Loss": [torch.sum(loss) / x.shape[0]]}
    return {"Loss": [loss]}


@register_op("label_smooth", inputs=["X", "PriorDist"], outputs=["Out"])
def _label_smooth(ctx, ins, attrs):
    x = ins["X"][0]
    eps = float(attrs.get("epsilon", 0.1))
    if ins.get("PriorDist"):
        return {"Out": [(1 - eps) * x + eps * ins["PriorDist"][0]]}
    return {"Out": [(1 - eps) * x + eps / x.shape[-1]]}


@register_op("cos_sim", inputs=["X", "Y"], outputs=["Out"])
def _cos_sim(ctx, ins, attrs):
    """Cosine similarity over the last axis, ``[..., 1]``; the norms'
    product is offset by 1e-12."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(x * x, -1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, -1, keepdim=True))
    return {"Out": [torch.sum(x * y, -1, keepdim=True) / (xn * yn + 1e-12)]}


# ---------------------------------------------------------------------------
# norm variants
# ---------------------------------------------------------------------------


@register_op("instance_norm", inputs=["X", "Scale", "Bias"],
             outputs=["Y", "SavedMean", "SavedVariance"],
             stateful_out_slots=("SavedMean", "SavedVariance"))
def _instance_norm(ctx, ins, attrs):
    """cf. instance_norm_op.cc: each (sample, channel) normalized over
    its spatial dims with the biased variance.  SavedMean and
    SavedVariance (the variance itself, not 1/std) are squeezed of
    every size-1 dim, as the reference's ``jnp.squeeze``; both are
    stateful slots, so a program's backward sends them no gradient."""
    x = ins["X"][0]
    eps = float(attrs.get("epsilon", 1e-5))
    red = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=red, keepdim=True)
    var = torch.var(x, dim=red, keepdim=True, correction=0)
    y = (x - mean) * torch.rsqrt(var + eps)
    shape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(shape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(shape)
    return {"Y": [y], "SavedMean": [mean.squeeze()],
            "SavedVariance": [var.squeeze()]}


# ---------------------------------------------------------------------------
# vision
# ---------------------------------------------------------------------------


@register_op("affine_grid", inputs=["Theta"], outputs=["Output"])
def _affine_grid(ctx, ins, attrs):
    """cf. affine_grid_op.cc: ``[N, 2, 3]`` theta -> ``[N, H, W, 2]``
    sampling grid over the reference's lattice (``linspace(-1, 1)``
    with ``align_corners``, pixel centres without)."""
    theta = ins["Theta"][0]
    h, w = attrs["output_shape"][2], attrs["output_shape"][3]
    kw = dict(dtype=theta.dtype, device=theta.device)
    if attrs.get("align_corners", True):
        ys = torch.linspace(-1.0, 1.0, h, **kw)
        xs = torch.linspace(-1.0, 1.0, w, **kw)
    else:
        ys = (torch.arange(h, **kw) + 0.5) * 2.0 / h - 1.0
        xs = (torch.arange(w, **kw) + 0.5) * 2.0 / w - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)   # [H, W, 3]
    return {"Output": [torch.einsum("hwk,nck->nhwc", base, theta)]}


@register_op("grid_sampler", inputs=["X", "Grid"], outputs=["Output"])
def _grid_sampler(ctx, ins, attrs):
    """cf. grid_sampler_op.cc: bilinear sample of ``[N, C, H, W]`` at
    ``[N, Ho, Wo, 2]`` normalized coordinates, each corner outside the
    image read as 0."""
    return {"Output": [F.grid_sample(
        ins["X"][0], ins["Grid"][0], mode="bilinear", padding_mode="zeros",
        align_corners=bool(attrs.get("align_corners", True)))]}


@register_op("pixel_shuffle", inputs=["X"], outputs=["Out"])
def _pixel_shuffle(ctx, ins, attrs):
    x = ins["X"][0]
    r = int(attrs["upscale_factor"])
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return {"Out": [x.reshape(n, c // (r * r), h * r, w * r)]}


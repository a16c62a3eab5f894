"""Dense math ops: the elementwise ops (with axis broadcast), the
activation table, leaky_relu, elu, gelu, hard_sigmoid, swish, relu6,
pow, scale, clip, softmax, log_softmax, matmul, mul, dot, sum and the
fused-epilogue matmul_bias_act.

Counterpart of `paddle_tpu/fluid/ops/math_ops.py` (the elementwise ops
:37-45, the activations :50-76, leaky_relu :85, elu :92, gelu :97,
hard_sigmoid :103, swish :110, relu6 :117, pow :122, scale :127, clip
:139, softmax :144, log_softmax :149, matmul :157, mul :179, dot :199,
matmul_bias_act :205, sum :297).  Where the obvious torch call's
gradient differs from JAX's at a kink, the lowering is written in the
form whose autograd gradient is JAX's: ``abs`` as ``where(x >= 0, x,
-x)`` (1 at 0), the clips as ``minimum(maximum(x, lo), hi)`` (half on
a bound, as ``jnp.clip``; ``torch.clamp`` passes all of it).  ``matmul`` is a plain
`torch.matmul`, as the reference's is a plain ``jnp.matmul``.  ``matmul_bias_act`` is the op that reaches a
hand kernel: it calls `ops.matmul.matmul_bias_act` (kernel 5), which
launches the kernel on a CUDA tensor and takes its plain version on a
CPU or meta one.
"""

import math

import torch
import torch.nn.functional as F

from ...ops import matmul as _matmul
from ..core.registry import register_op


def _paddle_bcast(x, y, axis):
    """Reference broadcast rule (elementwise_op.h): align Y to X at `axis`."""
    if x.dim() == y.dim():
        return x, y
    if y.dim() > x.dim():  # numpy-style fallback
        return x, y
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    new_shape = (1,) * axis + tuple(y.shape) + (1,) * (x.dim() - axis - y.dim())
    return x, y.reshape(new_shape)


def _register_elementwise(name, fn):
    @register_op("elementwise_" + name, inputs=["X", "Y"], outputs=["Out"])
    def _lower(ctx, ins, attrs, fn=fn):
        x, y = _paddle_bcast(ins["X"][0], ins["Y"][0], attrs.get("axis", -1))
        return {"Out": [fn(x, y)]}


_register_elementwise("add", torch.add)
_register_elementwise("sub", torch.sub)
_register_elementwise("mul", torch.mul)
_register_elementwise("div", torch.div)
_register_elementwise("pow", torch.pow)
# maximum / minimum split a tie's gradient in halves, as JAX's
_register_elementwise("max", torch.maximum)
_register_elementwise("min", torch.minimum)
# Python's modulo (the divisor's sign), as jnp.mod; not torch.fmod
_register_elementwise("mod", torch.remainder)
# piecewise constant: JAX's gradient is 0, torch has no derivative for it
_register_elementwise("floordiv", lambda x, y: torch.floor_divide(
    x.detach(), y.detach()))


def const_like(x, v):
    """``v`` as a 0-d tensor of ``x``'s dtype and device."""
    return torch.full((), v, dtype=x.dtype, device=x.device)


def clip(x, lo, hi):
    """``jnp.clip``: half the gradient on either bound (``torch.clamp``
    passes all of it)."""
    return torch.minimum(torch.maximum(x, const_like(x, lo)),
                         const_like(x, hi))


def _abs(x):
    """``jnp.abs``: gradient 1 at 0 (``torch.abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) without torch's linear
    threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


# -- activations (cf. activation_op.cc) --------------------------------------

_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "abs": _abs,
    "square": torch.square,
    "reciprocal": lambda x: 1.0 / x,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "round": torch.round,       # half to even, as jnp.round
    "sin": torch.sin,
    "cos": torch.cos,
    "softplus": softplus,
    "softsign": lambda x: x / (_abs(x) + 1),
    "silu": F.silu,
    "erf": torch.erf,
    "sign": torch.sign,
    "logsigmoid": lambda x: -softplus(-x),
}


def _register_activation(name, fn):
    @register_op(name, inputs=["X"], outputs=["Out"])
    def _lower(ctx, ins, attrs, fn=fn):
        return {"Out": [fn(ins["X"][0])]}


for _name, _fn in _ACTIVATIONS.items():
    _register_activation(_name, _fn)


@register_op("leaky_relu", inputs=["X"], outputs=["Out"])
def _leaky_relu(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.where(x >= 0, x, attrs.get("alpha", 0.02) * x)]}


@register_op("elu", inputs=["X"], outputs=["Out"])
def _elu(ctx, ins, attrs):
    """``jax.nn.elu``: alpha (e^x - 1) at x <= 0."""
    x = ins["X"][0]
    pos = x > 0
    neg = attrs.get("alpha", 1.0) * torch.expm1(torch.where(pos, 0.0, x))
    return {"Out": [torch.where(pos, x, neg)]}


@register_op("gelu", inputs=["X"], outputs=["Out"])
def _gelu(ctx, ins, attrs):
    approx = attrs.get("approximate", False)
    return {"Out": [F.gelu(ins["X"][0],
                           approximate="tanh" if approx else "none")]}


@register_op("hard_sigmoid", inputs=["X"], outputs=["Out"])
def _hard_sigmoid(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [clip(x * attrs.get("slope", 0.2)
                         + attrs.get("offset", 0.5), 0.0, 1.0)]}


@register_op("swish", inputs=["X"], outputs=["Out"])
def _swish(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x * torch.sigmoid(attrs.get("beta", 1.0) * x)]}


@register_op("relu6", inputs=["X"], outputs=["Out"])
def _relu6(ctx, ins, attrs):
    return {"Out": [clip(ins["X"][0], 0.0, attrs.get("threshold", 6.0))]}


@register_op("pow", inputs=["X"], outputs=["Out"])
def _pow(ctx, ins, attrs):
    return {"Out": [torch.pow(ins["X"][0], attrs.get("factor", 1.0))]}


@register_op("scale", inputs=["X"], outputs=["Out"])
def _scale(ctx, ins, attrs):
    x = ins["X"][0]
    s = attrs.get("scale", 1.0)
    b = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        out = x * s + b
    else:
        out = (x + b) * s
    return {"Out": [out.to(x.dtype)]}


@register_op("clip", inputs=["X"], outputs=["Out"])
def _clip_op(ctx, ins, attrs):
    return {"Out": [clip(ins["X"][0], attrs["min"], attrs["max"])]}


@register_op("softmax", inputs=["X"], outputs=["Out"])
def _softmax(ctx, ins, attrs):
    return {"Out": [torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))]}


@register_op("log_softmax", inputs=["X"], outputs=["Out"])
def _log_softmax(ctx, ins, attrs):
    return {"Out": [torch.log_softmax(ins["X"][0],
                                      dim=attrs.get("axis", -1))]}


# -- matmul family -----------------------------------------------------------


@register_op("matmul", inputs=["X", "Y"], outputs=["Out"])
def _matmul_op(ctx, ins, attrs):
    """cf. matmul_op.cc: optional transposes + alpha, batched by leading
    dims."""
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("transpose_X", attrs.get("transpose_x", False)) \
            and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", attrs.get("transpose_y", False)) \
            and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


@register_op("mul", inputs=["X", "Y"], outputs=["Out"])
def _mul(ctx, ins, attrs):
    """cf. mul_op.cc: flatten X to 2D at x_num_col_dims, Y at y_num_col_dims."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    x2 = x.reshape(-1, math.prod(x.shape[xn:]))
    y2 = y.reshape(math.prod(y.shape[:yn]), -1)
    out_shape = tuple(x.shape[:xn]) + tuple(y.shape[yn:])
    return {"Out": [torch.matmul(x2, y2).reshape(out_shape)]}


@register_op("dot", inputs=["X", "Y"], outputs=["Out"])
def _dot(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [torch.sum(x * y, dim=-1, keepdim=True)]}


MBA_ACTIVATIONS = ("none", "relu", "tanh", "gelu")


def _naive_batched(x, w, bias, alpha, act, approx):
    """A batched ``Y`` (more than 2-D) has no kernel: the plain
    composition, taken only off the card."""
    if x.is_cuda:
        raise ValueError(
            "matmul_bias_act: the kernel is 2-D and takes no batched Y "
            "(%s)" % (tuple(w.shape),))
    out = torch.matmul(x, w) * alpha
    if bias is not None:
        out = out + bias
    return _matmul._apply_act(out, act, approx)


@register_op("matmul_bias_act", inputs=["X", "Y", "Bias"], outputs=["Out"])
def _matmul_bias_act(ctx, ins, attrs):
    """Fused-epilogue GEMM: act(X·Y + Bias) as ONE kernel launch.

    attrs: ``act_type`` in {none, relu, tanh, gelu} (+``approximate``
    for the tanh gelu), and ONE of the two source-op attr conventions —
    mul-style ``x_num_col_dims``/``y_num_col_dims`` flattening, or
    matmul-style ``transpose_X``/``transpose_Y``/``alpha``.

    Y is ``[K, N]`` in the IR; the kernel takes ``[N, K]``.  An op whose
    ``weight_layout`` attr is ``"NK"`` reads a Y already transposed
    once (the inference `Predictor` does so for its constant weights
    when it loads); otherwise Y is transposed here, a copy each call.
    Any 2-D product launches kernel 5 on a CUDA tensor, whatever its
    shape (the reference takes its Pallas kernel only for 128-tileable
    shapes on a TPU, `paddle_tpu/fluid/ops/math_ops.py:252-258`)."""
    x, w = ins["X"][0], ins["Y"][0]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    act = attrs.get("act_type", "none")
    if act not in MBA_ACTIVATIONS:
        raise ValueError(
            "matmul_bias_act act_type must be one of %s, got %r"
            % (MBA_ACTIVATIONS, act))
    approx = bool(attrs.get("approximate", False))
    nk = attrs.get("weight_layout", "KN") == "NK"
    xn = attrs.get("x_num_col_dims")
    if xn is not None:                      # mul-style flatten
        if nk:
            w_nk = w
        else:
            yn = attrs.get("y_num_col_dims", 1)
            w_nk = w.reshape(math.prod(w.shape[:yn]), -1).t()
        lead = tuple(x.shape[:xn])
        x2 = x.reshape(-1, math.prod(x.shape[xn:]))
    else:                                   # matmul-style
        tx = attrs.get("transpose_X", attrs.get("transpose_x", False))
        ty = attrs.get("transpose_Y", attrs.get("transpose_y", False))
        alpha = attrs.get("alpha", 1.0)
        if tx and x.dim() > 1:
            x = x.transpose(-1, -2)
        if not nk and w.dim() > 2:
            if ty:
                w = w.transpose(-1, -2)
            return {"Out": [_naive_batched(x, w, bias, alpha, act, approx)]}
        w_nk = w if (nk or ty) else w.t()
        if alpha != 1.0:
            x = x * alpha
        lead = tuple(x.shape[:-1])
        x2 = x.reshape(-1, x.shape[-1])
    y = _matmul.matmul_bias_act(x2.contiguous(), w_nk.contiguous(), bias,
                                activation=act, approximate=approx)
    return {"Out": [y.reshape(lead + (w_nk.shape[0],))]}


@register_op("sum", inputs=["X"], outputs=["Out"])
def _sum(ctx, ins, attrs):
    """Multi-input elementwise add (grad accumulation; cf. sum_op.cc),
    left to right."""
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}

"""1x1 convolution + BatchNorm: the hand-written kernels on CUDA tensors,
their plain PyTorch versions on CPU tensors, and the BN fold that feeds
the eval one.

Two kernels over a 1x1 convolution's channels-last rows, x ``[M, K]``
(M = B·H·W rows of Cin channels) and w ``[N, K]`` (the Conv2D weight
``[Cout, Cin, 1, 1]`` viewed as ``[Cout, Cin]``; the TPU kernels' w is
``[K, N]``), both on the port's forward GEMM body: in bf16
`gemm_tc.cuh`'s ``fwd_tc`` (``wgmma`` + TMA, one CTA an SM walking
``128 x bn`` output tiles, ``bn`` from `conv_schedule`), in f32
`gemm_common.cuh`'s exact-FMA kernel:

* **Eval** (`conv1x1_bn_relu`, ``csrc/conv_bn_relu.cu``): counterpart of
  `benchmarks/fused_conv_bn_relu_experiment.py` `pallas_fused` (kernel
  ``fused_kernel``), ``relu(x w · scale + shift)`` with a per-channel f32
  scale and shift, rounded once to x's dtype.  That is the eval-mode
  `ConvBNLayer(k=1, stride=1, act="relu")` of the JAX ResNet
  (`paddle_tpu/models/resnet.py:20-32`): the 1x1 conv, BatchNorm's
  ``is_test`` branch (`fluid/ops/nn_ops.py:279-288`) folded by `fold_bn`,
  and the relu act.
* **Train** (`conv1x1_bn_stats`, ``csrc/conv_bn_stats.cu``): counterpart
  of the experiment's `pallas_mm_stats` (kernel ``fused_stats_kernel``),
  the conv and the per-channel statistics BatchNorm's batch mode needs:
  y ``[M, N]`` in x's dtype, rounded once from the f32 accumulator, and
  the f32 mean and biased variance ``[N]`` of the unrounded accumulator
  (the TPU kernel's Σy and Σy², taken before rounding too).  It is the
  first half of a train-mode 1x1, stride-1 `ConvBNLayer`; the normalize
  is `nn_ops.batch_norm_train` on its statistics.  The statistics come
  from per-tile partials merged in a fixed order (bitwise the same from
  run to run) and never as Σy²/M − μ², which cancels when |mean| ≫ std.

There is no size threshold and no fallback: a CUDA tensor launches the
kernel or raises, at any M, N and K (ragged edges are masked in the
kernel); bf16 operands need K and N to be multiples of 8 (TMA's 16-byte
row strides); operands must be contiguous (no copy is made) and 16-byte
aligned, on every device.  Both are
`torch.autograd.Function`s whose backward is plain torch (no kernel:
in the JAX package these products are XLA's conv backward, outside any
Pallas kernel): the eval one masks dy by y > 0 and recomputes the f32
product for dscale; the train one combines the gradients of y, mean and
var into one dY and takes ``dX = dY w`` and ``dW = dYᵀ x``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .matmul import H100_SMS, _sm_count, fwd_tiles

__all__ = ["conv1x1_bn_relu", "conv1x1_bn_relu_reference", "conv1x1_bn_stats",
           "conv1x1_bn_stats_reference", "conv_schedule", "fold_bn"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_RELU_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_STATS_ARGTYPES = [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                   _P]


def fold_bn(gamma, beta, mean, var, eps):
    """The eval BatchNorm as one per-channel affine, in f32: ``scale =
    gamma · rsqrt(var + eps)`` and ``shift = beta − mean · scale``, so
    that ``(x − mean) · rsqrt(var + eps) · gamma + beta = x · scale +
    shift``."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    return scale, beta.float() - mean.float() * scale


def conv1x1_bn_relu_reference(x2d, w2d, scale, shift):
    """Plain version of the eval kernel: the f32 product, the affine and
    the relu, rounded once to x's dtype."""
    acc = torch.matmul(x2d.float(), w2d.float().t())
    return torch.relu(acc * scale.float() + shift.float()).to(x2d.dtype)


def conv1x1_bn_stats_reference(x2d, w2d):
    """Plain version of the train kernel: the f32 product rounded once to
    x's dtype, and the mean and biased variance of each column of the
    f32 product, reduced in float64 and returned in f32."""
    acc = torch.matmul(x2d.float(), w2d.float().t())
    var, mean = torch.var_mean(acc.double(), dim=0, unbiased=False)
    return acc.to(x2d.dtype), mean.float(), var.float()


# the bf16 kernels' output tile widths: gemm_tc.cuh's forward body, one
# instantiation a width, over tiles of `matmul.FWD_ROWS` rows walked as
# `matmul.fwd_tile_plan` gives them
TILE_WIDTHS = (64, 128, 256)


def conv_schedule(m, n, sms=H100_SMS):
    """``(bn, ctas)`` of a bf16 launch: the narrowest tile width that
    holds N (256 above that), and the CTAs that walk the tiles (one an
    SM, at most one a tile).  `tools/conv_bn_probe.py`'s sweep on the
    H100 (PERF.md) found this width the fastest, or within the noise,
    at every path shape of both kernels: narrower tiles re-read x once a
    column tile, and at M = 6272 the 128-wide tiles that fill more SMs
    were no faster."""
    bn = next((w for w in TILE_WIDTHS if w >= n), TILE_WIDTHS[-1])
    return bn, min(fwd_tiles(m, n, bn), sms)


def _check_args(name, x2d, w2d, vecs=()):
    """The kernels' argument contract, held on every device so that the
    CPU runs show the card's path takes its operands as they come."""
    if x2d.dim() != 2 or w2d.dim() != 2:
        raise ValueError(
            "%s is a 2-D kernel: x [M, K] %s, w [N, K] %s — view the "
            "channels-last activation as [B*H*W, Cin] and the weight as "
            "[Cout, Cin]" % (name, tuple(x2d.shape), tuple(w2d.shape)))
    if x2d.shape[1] != w2d.shape[1]:
        raise ValueError("%s: x [M, K] = %s and w [N, K] = %s disagree in K"
                         % (name, tuple(x2d.shape), tuple(w2d.shape)))
    m, k = x2d.shape
    n = w2d.shape[0]
    for vname, t in vecs:
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError("%s: %s must be [N=%d], got %s"
                             % (name, vname, n, tuple(t.shape)))
        if t.dtype != torch.float32:
            raise ValueError("%s: %s must be float32, got %s"
                             % (name, vname, t.dtype))
    _build.dtype_code(x2d)
    if w2d.dtype != x2d.dtype:
        raise ValueError("%s: w is %s, x is %s" % (name, w2d.dtype,
                                                   x2d.dtype))
    for tname, t in (("x", x2d), ("w", w2d)) + tuple(vecs):
        if not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous, got strides %s"
                             % (name, tname, t.stride()))
        if t.data_ptr() % 16:   # TMA and the 16-byte loads
            raise ValueError("%s: %s must be 16-byte aligned" % (name, tname))
    if min(m, n, k) <= 0:
        raise ValueError("%s: empty operands (M=%d, N=%d, K=%d)"
                         % (name, m, n, k))
    if x2d.dtype == torch.bfloat16 and (k % 8 or n % 8):
        raise ValueError(
            "%s: bf16 operands need K and N to be multiples of 8 (16-byte "
            "loads), got K=%d, N=%d" % (name, k, n))


def _check_cuda(name, x2d, tensors):
    for tname, t in tensors:
        if not t.is_cuda or t.device != x2d.device:
            raise ValueError("%s: %s must lie on %s with x"
                             % (name, tname, x2d.device))


def _conv_bn_relu_fwd(x2d, w2d, scale, shift):
    if not x2d.is_cuda:
        return conv1x1_bn_relu_reference(x2d, w2d, scale, shift)
    _check_cuda("conv1x1_bn_relu", x2d, (("x", x2d), ("w", w2d),
                                         ("scale", scale), ("shift", shift)))
    m, n = x2d.shape[0], w2d.shape[0]
    y = torch.empty(m, n, dtype=x2d.dtype, device=x2d.device)
    _launch_conv_bn_relu(x2d, w2d, scale, shift, y,
                         *conv_schedule(m, n, _sm_count(x2d.device)))
    conv1x1_bn_relu.launches += 1
    return y


def _launch_conv_bn_relu(x2d, w2d, scale, shift, y, bn, ctas):
    """Kernel 10's launch into ``y``; bf16 on ``bn``-wide tiles walked by
    ``ctas`` CTAs (the f32 kernel takes one a 64 x 64 tile whatever they
    say)."""
    m, k = x2d.shape
    _build.launch(
        "conv_bn_relu", "conv_bn_relu_fwd", _RELU_ARGTYPES, x2d.data_ptr(),
        w2d.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(), m,
        w2d.shape[0], k, _build.dtype_code(x2d), bn, ctas,
        _build.stream_ptr(x2d.device))


class _ConvBnRelu(torch.autograd.Function):
    """The eval kernel's forward; plain backward: dZ = dy · [y > 0],
    dshift = Σ dZ, dscale = Σ dZ · (x w) with the f32 product recomputed,
    then dX = (dZ · scale) w and dW = (dZ · scale)ᵀ x in x's dtype."""

    @staticmethod
    def forward(ctx, x2d, w2d, scale, shift):
        y = _conv_bn_relu_fwd(x2d, w2d, scale, shift)
        ctx.save_for_backward(x2d, w2d, scale, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, w2d, scale, y = ctx.saved_tensors
        need_x, need_w, need_scale, need_shift = ctx.needs_input_grad
        dz = torch.where(y > 0, dy.float(), 0.0)
        dscale = dshift = dx = dw = None
        if need_scale:
            acc = torch.matmul(x2d.float(), w2d.float().t())
            dscale = (dz * acc).sum(0)
            del acc
        if need_shift:
            dshift = dz.sum(0)
        dacc = (dz * scale).to(x2d.dtype)
        if need_x:
            dx = torch.matmul(dacc, w2d)
        if need_w:
            dw = torch.matmul(dacc.t(), x2d)
        return dx, dw, dscale, dshift


def conv1x1_bn_relu(x2d, w2d, scale, shift):
    """``relu(x2d w2dᵀ · scale + shift)`` in x's dtype: x ``[M, K]``, w
    ``[N, K]``, f32 scale and shift ``[N]``.  CUDA tensors launch the
    kernel; CPU tensors take the plain version.  Differentiable in all
    four operands."""
    _check_args("conv1x1_bn_relu", x2d, w2d, (("scale", scale),
                                              ("shift", shift)))
    return _ConvBnRelu.apply(x2d, w2d, scale, shift)


conv1x1_bn_relu.launches = 0


def _conv_bn_stats_fwd(x2d, w2d):
    if not x2d.is_cuda:
        return conv1x1_bn_stats_reference(x2d, w2d)
    _check_cuda("conv1x1_bn_stats", x2d, (("x", x2d), ("w", w2d)))
    out = _launch_conv_bn_stats(
        x2d, w2d, *conv_schedule(x2d.shape[0], w2d.shape[0],
                                 _sm_count(x2d.device)))
    conv1x1_bn_stats.launches += 1
    return out


def _launch_conv_bn_stats(x2d, w2d, bn, ctas):
    """Kernel 11's two launches: ``(y, mean, var)``; bf16 on ``bn``-wide
    tiles walked by ``ctas`` CTAs (the f32 kernel takes one a 64 x 64
    tile whatever they say)."""
    m, k = x2d.shape
    n = w2d.shape[0]
    dev = x2d.device
    # one (mean, M2) partial per (row tile, column); the kernel's tile
    tiles = _build.query("conv_bn_stats", "conv_bn_stats_part_tiles",
                         [_I, _I], m, _build.dtype_code(x2d))
    y = torch.empty(m, n, dtype=x2d.dtype, device=dev)
    part = torch.empty(2, tiles, n, dtype=torch.float32, device=dev)
    mean = torch.empty(n, dtype=torch.float32, device=dev)
    var = torch.empty(n, dtype=torch.float32, device=dev)
    _build.launch(
        "conv_bn_stats", "conv_bn_stats_fwd", _STATS_ARGTYPES, x2d.data_ptr(),
        w2d.data_ptr(), y.data_ptr(), part.data_ptr(), tiles, mean.data_ptr(),
        var.data_ptr(), m, n, k, _build.dtype_code(x2d), bn, ctas,
        _build.stream_ptr(dev))
    return y, mean, var


class _ConvBnStats(torch.autograd.Function):
    """The train kernel's forward; plain backward: the gradients of y,
    mean and var meet in ``dY = dy + dmean / M + dvar · 2 (y − mean) /
    M`` (f32), then ``dX = dY w`` and ``dW = dYᵀ x`` in x's dtype."""

    @staticmethod
    def forward(ctx, x2d, w2d):
        y, mean, var = _conv_bn_stats_fwd(x2d, w2d)
        ctx.save_for_backward(x2d, w2d, y, mean)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x2d, w2d, y, mean = ctx.saved_tensors
        m = x2d.shape[0]
        dyc = (dy.float() + dmean / m
               + (y.float() - mean) * (dvar * (2.0 / m))).to(x2d.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(dyc, w2d)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(dyc.t(), x2d)
        return dx, dw


def conv1x1_bn_stats(x2d, w2d):
    """``(y, mean, var)``: y = x2d w2dᵀ ``[M, N]`` in x's dtype, and the
    f32 mean and biased variance ``[N]`` of each column of the f32
    product.  x ``[M, K]``, w ``[N, K]``.  CUDA tensors launch the kernel;
    CPU tensors take the plain version.  Differentiable in x and w
    through all three outputs."""
    _check_args("conv1x1_bn_stats", x2d, w2d)
    return _ConvBnStats.apply(x2d, w2d)


conv1x1_bn_stats.launches = 0

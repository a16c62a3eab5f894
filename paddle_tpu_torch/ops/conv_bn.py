"""1x1 convolution + eval-mode BatchNorm + relu: the hand-written kernel
on CUDA tensors, its plain PyTorch version on CPU tensors, and the BN
fold that feeds both.

Counterpart of `benchmarks/fused_conv_bn_relu_experiment.py`
`pallas_fused` (kernel ``fused_kernel``), which computes
``relu(x w · scale + shift)`` over a 1x1 convolution's channels-last
rows with a per-channel f32 scale and shift.  That is the eval-mode
`ConvBNLayer(k=1, stride=1, act="relu")` of the JAX ResNet
(`paddle_tpu/models/resnet.py:20-32`): the 1x1 conv, BatchNorm's
``is_test`` branch (`fluid/ops/nn_ops.py:279-288`) and the relu act.

The kernel (``csrc/conv_bn_relu.cu``, over `gemm_common.cuh`'s forward
GEMM with a BN-affine + relu epilogue) takes x ``[M, K]`` (M = B·H·W
rows of Cin channels), w ``[N, K]`` (the Conv2D weight ``[Cout, Cin, 1,
1]`` viewed as ``[Cout, Cin]``; the TPU kernel's w is ``[K, N]``), and
f32 ``scale`` and ``shift`` ``[N]``, and returns y ``[M, N]`` in x's
dtype: the f32 accumulator times scale plus shift, relu, rounded once.

There is no size threshold and no fallback: a CUDA tensor launches the
kernel or raises, at any M, N and K (ragged edges are masked in the
kernel); bf16 operands need K and N to be multiples of 8 (16-byte
loads); operands must be contiguous (no copy is made).  The kernel has
no backward: on the card it raises when autograd would need one.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["conv1x1_bn_relu", "conv1x1_bn_relu_reference", "fold_bn"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]


def fold_bn(gamma, beta, mean, var, eps):
    """The eval BatchNorm as one per-channel affine, in f32: ``scale =
    gamma · rsqrt(var + eps)`` and ``shift = beta − mean · scale``, so
    that ``(x − mean) · rsqrt(var + eps) · gamma + beta = x · scale +
    shift``."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    return scale, beta.float() - mean.float() * scale


def conv1x1_bn_relu_reference(x2d, w2d, scale, shift):
    """Plain version of the kernel: the f32 product, the affine and the
    relu, rounded once to x's dtype."""
    acc = torch.matmul(x2d.float(), w2d.float().t())
    return torch.relu(acc * scale.float() + shift.float()).to(x2d.dtype)


def _check_args(x2d, w2d, scale, shift):
    """The kernel's argument contract, held on every device so that the
    CPU runs show the card's path takes its operands as they come."""
    if x2d.dim() != 2 or w2d.dim() != 2:
        raise ValueError(
            "conv1x1_bn_relu is a 2-D kernel: x [M, K] %s, w [N, K] %s — "
            "view the channels-last activation as [B*H*W, Cin] and the "
            "weight as [Cout, Cin]" % (tuple(x2d.shape), tuple(w2d.shape)))
    if x2d.shape[1] != w2d.shape[1]:
        raise ValueError("conv1x1_bn_relu: x [M, K] = %s and w [N, K] = %s "
                         "disagree in K" % (tuple(x2d.shape),
                                            tuple(w2d.shape)))
    m, k = x2d.shape
    n = w2d.shape[0]
    for name, t in (("scale", scale), ("shift", shift)):
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError("conv1x1_bn_relu: %s must be [N=%d], got %s"
                             % (name, n, tuple(t.shape)))
        if t.dtype != torch.float32:
            raise ValueError("conv1x1_bn_relu: %s must be float32, got %s"
                             % (name, t.dtype))
    _build.dtype_code(x2d)
    if w2d.dtype != x2d.dtype:
        raise ValueError("conv1x1_bn_relu: w is %s, x is %s"
                         % (w2d.dtype, x2d.dtype))
    for name, t in (("x", x2d), ("w", w2d), ("scale", scale),
                    ("shift", shift)):
        if not t.is_contiguous():
            raise ValueError("conv1x1_bn_relu: %s must be contiguous, got "
                             "strides %s" % (name, t.stride()))
    if min(m, n, k) <= 0:
        raise ValueError("conv1x1_bn_relu: empty operands (M=%d, N=%d, K=%d)"
                         % (m, n, k))
    if x2d.dtype == torch.bfloat16 and (k % 8 or n % 8):
        raise ValueError(
            "conv1x1_bn_relu: bf16 operands need K and N to be multiples of "
            "8 (16-byte loads), got K=%d, N=%d" % (k, n))


def _check_cuda(x2d, w2d, scale, shift):
    for name, t in (("x", x2d), ("w", w2d), ("scale", scale),
                    ("shift", shift)):
        if not t.is_cuda or t.device != x2d.device:
            raise ValueError("conv1x1_bn_relu: %s must lie on %s with x"
                             % (name, x2d.device))
        if t.data_ptr() % 16:
            raise ValueError("conv1x1_bn_relu: %s must be 16-byte aligned"
                             % name)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x2d, w2d, scale, shift)):
        raise RuntimeError(
            "conv1x1_bn_relu has no backward on the card; call it under "
            "torch.no_grad() or torch.inference_mode()")


def conv1x1_bn_relu(x2d, w2d, scale, shift):
    """``relu(x2d w2dᵀ · scale + shift)`` in x's dtype: x ``[M, K]``, w
    ``[N, K]``, f32 scale and shift ``[N]``.  CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    _check_args(x2d, w2d, scale, shift)
    if not x2d.is_cuda:
        return conv1x1_bn_relu_reference(x2d, w2d, scale, shift)
    _check_cuda(x2d, w2d, scale, shift)
    m, k = x2d.shape
    n = w2d.shape[0]
    y = torch.empty(m, n, dtype=x2d.dtype, device=x2d.device)
    _build.launch(
        "conv_bn_relu", "conv_bn_relu_fwd", _ARGTYPES, x2d.data_ptr(),
        w2d.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(), m,
        n, k, _build.dtype_code(x2d), _build.stream_ptr(x2d.device))
    conv1x1_bn_relu.launches += 1
    return y


conv1x1_bn_relu.launches = 0

"""Scaled-dot-product attention: the hand-written flash forward
(``csrc/flash_fwd.cu``) on CUDA tensors, the plain PyTorch composition
on CPU tensors.

Counterpart of `paddle_tpu.ops.attention` (dispatch and the naive
composition) and `paddle_tpu.ops.pallas.attention.flash_attention`
(the kernel).  Unlike the JAX dispatch, there is no size threshold: a
CUDA tensor always launches the kernel, whatever S is, and any S works
(ragged edges are masked in the kernel, not padded).

Left for the BERT slice: the additive row bias and segment ids (the
functions raise when given them), and the LSE output the backward
needs.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_attention", "naive_attention_with_layout",
           "scaled_dot_product_attention"]

NEG_INF = -1e30
_LAYOUTS = ("BHSD", "BSHD")
# flash_fwd(q, k, v, o, B, H, Sq, Sk, D, strides[12], scale, causal,
#           dtype, stream) in csrc/flash_fwd.cu
_FLASH_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _naive_attention(q, k, v, bias, scale, causal):
    """BHSD plain composition, mirroring `paddle_tpu.ops.attention.
    _naive_attention`.  bf16 inputs are upcast to f32 before the
    products (the Pallas kernel's arithmetic); the result is cast back."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        qs, ks = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(qs, ks, dtype=torch.bool,
                          device=logits.device).tril(ks - qs)
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    # a fully-masked row would softmax to uniform and emit mean(V);
    # hard-zero masked entries so it emits zeros
    probs = torch.where(logits <= NEG_INF / 2, 0.0, probs)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def naive_attention_with_layout(q, k, v, bias, scale, causal, layout="BHSD"):
    if layout == "BSHD":
        out = _naive_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), bias, scale, causal)
        return out.transpose(1, 2)
    return _naive_attention(q, k, v, bias, scale, causal)


def _bsh_strides(t, layout):
    """(batch, seq, head) element strides of a 4-D tensor."""
    if layout == "BSHD":
        return t.stride(0), t.stride(1), t.stride(2)
    return t.stride(0), t.stride(2), t.stride(1)


def _flash_cuda(q, k, v, scale, causal, layout):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash_attention: %s must lie on %s with q"
                             % (name, q.device))
        if t.dim() != 4 or t.dtype != q.dtype or t.stride(-1) != 1:
            raise ValueError(
                "flash_attention: %s must be a 4-D %s tensor with a "
                "unit-stride head dim, got shape %s dtype %s strides %s"
                % (name, q.dtype, tuple(t.shape), t.dtype, t.stride()))
    if layout == "BSHD":
        b, sq, h, d = q.shape
        sk = k.shape[1]
    else:
        b, h, sq, d = q.shape
        sk = k.shape[2]
    if k.shape != v.shape or (k.shape[0], k.shape[-1]) != (b, d) or \
            k.shape[2 if layout == "BSHD" else 1] != h:
        raise ValueError("flash_attention: q %s, k %s, v %s do not agree "
                         "in layout %s" % (tuple(q.shape), tuple(k.shape),
                                           tuple(v.shape), layout))
    if d not in (64, 128):
        raise ValueError("flash_attention: head dim must be 64 or 128, "
                         "got %d" % d)
    code = _build.dtype_code(q)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_longlong * 12)(
        *_bsh_strides(q, layout), *_bsh_strides(k, layout),
        *_bsh_strides(v, layout), *_bsh_strides(out, layout))
    _build.launch("flash_fwd", "flash_fwd", _FLASH_ARGTYPES,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, h, sq, sk, d, strides, scale, int(bool(causal)), code,
                  _build.stream_ptr(q.device))
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, bias=None, segment_ids=None, scale=None,
                    causal=False, layout="BSHD"):
    """q/k/v: [B, S, H, D] (layout="BSHD") or [B, H, S, D] ("BHSD").
    Causal masking is bottom-right aligned (query row i sees key j iff
    j <= i + Sk - Sq); a row with no visible key emits zeros.  f32 or
    bf16 in, same dtype out, f32 arithmetic.

    CUDA tensors launch the kernel (head dim 64 or 128, last dim unit
    stride; other strides are read as given, so no copy is made).  CPU
    tensors take the plain composition."""
    if bias is not None or segment_ids is not None:
        raise NotImplementedError(
            "flash_attention: row bias and segment ids are not ported yet")
    if layout not in _LAYOUTS:
        raise ValueError("layout must be BHSD or BSHD, got %r" % (layout,))
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if q.is_cuda:
        return _flash_cuda(q, k, v, float(scale), causal, layout)
    return naive_attention_with_layout(q, k, v, None, scale, causal, layout)


flash_attention.launches = 0


def scaled_dot_product_attention(q, k, v, bias=None, segment_ids=None,
                                 scale=None, causal=False, layout="BHSD"):
    """The dispatch of `paddle_tpu.ops.attention`: the flash kernel for
    CUDA tensors at every size, the plain composition for CPU tensors."""
    return flash_attention(q, k, v, bias=bias, segment_ids=segment_ids,
                           scale=scale, causal=causal, layout=layout)

"""Single-token attention over a dense KV cache (the decode step).

Counterpart of `paddle_tpu.ops.pallas.decode_attention`.  CUDA tensors
launch the hand-written kernel (``csrc/decode_attention.cu``, body in
``csrc/decode_common.cuh``); CPU tensors take
`decode_attention_reference`, the plain PyTorch version.

Layout: cache [N, T, H, D] (slot, position, head, head dim), query
[N, H, D]; positions ``t < lengths[n]`` are attended, and a slot with
length 0 emits zeros.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["decode_attention", "decode_attention_reference"]

NEG_INF = -1e30
# decode_attention(q, k, v, o, lengths, N, H, T, D, scale, dtype, stream)
# in csrc/decode_attention.cu
_DENSE_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def decode_attention_reference(q, k_cache, v_cache, lengths, scale=None):
    """Plain version: q [N, H, D], k/v_cache [N, T, H, D], lengths [N].
    Mirrors `paddle_tpu.ops.pallas.decode_attention.
    decode_attention_reference`."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    s = torch.einsum("nhd,nthd->nht", q.float(), k_cache.float()) * scale
    t = torch.arange(k_cache.shape[1], device=q.device)
    valid = t[None, :] < lengths.to(q.device)[:, None].long()   # [N, T]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    safe_m = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - safe_m))
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.clamp(l, min=1e-30)
    out = torch.einsum("nht,nthd->nhd", p, v_cache.float())
    dead = m <= NEG_INF / 2                                     # [N, H, 1]
    return torch.where(dead, 0.0, out).to(q.dtype)


def check_decode_operands(name, q, k, v, lengths, extra=()):
    """Device / dtype / shape / contiguity checks shared by the dense
    and paged wrappers; returns (N, H, D)."""
    if q.dim() != 3:
        raise ValueError("%s: q must be [N, H, D], got %s"
                         % (name, tuple(q.shape)))
    n, h, d = q.shape
    for what, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("%s: %s must lie on %s with q"
                             % (name, what, q.device))
        if t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError("%s: %s must be a contiguous %s tensor, got "
                             "%s" % (name, what, q.dtype, t.dtype))
    if k.shape != v.shape or k.dim() != 4 or k.shape[2:] != (h, d):
        raise ValueError("%s: caches %s / %s do not fit q %s"
                         % (name, tuple(k.shape), tuple(v.shape),
                            tuple(q.shape)))
    for what, t in (("lengths", lengths),) + tuple(extra):
        if t.device != q.device or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError("%s: %s must be a contiguous int32 tensor on "
                             "%s" % (name, what, q.device))
    if lengths.shape != (n,):
        raise ValueError("%s: lengths must be [%d], got %s"
                         % (name, n, tuple(lengths.shape)))
    if d not in (64, 128):
        raise ValueError("%s: head dim must be 64 or 128, got %d"
                         % (name, d))
    return n, h, d


def decode_attention(q, k_cache, v_cache, lengths, scale=None):
    """One decode step of attention over the dense cache.

    q [N, H, D]; k/v_cache [N, T, H, D]; lengths [N] int32 — positions
    ``t < lengths[n]`` are attended (the caller writes the current
    token's K/V before calling, so the token attends to itself).
    Returns [N, H, D]."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if not q.is_cuda:
        return decode_attention_reference(q, k_cache, v_cache, lengths, scale)
    n, h, d = check_decode_operands("decode_attention", q, k_cache, v_cache,
                                    lengths)
    code = _build.dtype_code(q)
    out = torch.empty_like(q)
    _build.launch("decode_attention", "decode_attention", _DENSE_ARGTYPES,
                  q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  out.data_ptr(), lengths.data_ptr(), n, h, k_cache.shape[1],
                  d, scale, code, _build.stream_ptr(q.device))
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

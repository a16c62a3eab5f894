"""Single-token attention over a dense KV cache (the decode step).

Counterpart of `paddle_tpu.ops.pallas.decode_attention`.  CUDA tensors
launch the hand-written kernel (``csrc/decode_attention.cu``, body in
``csrc/decode_common.cuh``), which splits each slot's key range into
the chunks `decode_split_plan` gives and merges their partials in chunk
order in the same launch; CPU tensors take
`decode_attention_reference`, the plain PyTorch version.

Layout: cache [N, T, H, D] (slot, position, head, head dim), query
[N, H, D]; positions ``t < lengths[n]`` are attended, and a slot with
length 0 emits zeros.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["decode_attention", "decode_attention_reference",
           "decode_head_groups", "decode_split_plan"]

NEG_INF = -1e30
# decode_attention(q, k, v, o, lengths, acc, ml, counters, N, H, T, D,
#                  chunk, chunks, hg, scale, dtype, stream)
# in csrc/decode_attention.cu
_DENSE_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

# The split of the key range (csrc/decode_common.cuh): chunks of whole
# planning units (a pool block of bs rows; DECODE_GRANULE rows for the
# dense cache, the engine's default block size, so that dense and paged
# plan alike), at most DECODE_MAX_CHUNKS a slot; at most
# DECODE_MAX_HEADS heads (one warp each) a CTA.  The two maxima are the
# fastest of `tools/decode_probe.py`'s sweep on the H100 (PERF.md): at T
# = 1024 and 12 heads, 32 chunks of 32 rows and 2 CTAs of 6 heads a
# chunk, where one CTA of every head reads whole cache rows but leaves
# half as many CTAs to hide the loads' latency.
DECODE_GRANULE = 16
DECODE_MAX_CHUNKS = 32
DECODE_MAX_HEADS = 6


def _cdiv(a, b):
    return -(-a // b)


def decode_split_plan(cap, bs=DECODE_GRANULE, max_chunks=DECODE_MAX_CHUNKS):
    """The kernels' chunks of a slot's key range: ``(chunk, chunks)``.

    ``cap`` is the positions the cache holds for a slot (the dense T, or
    max_blocks * bs), never the lengths, which live on the card.  A
    chunk is the fewest whole units of ``bs`` rows that keep ``chunks``
    within ``max_chunks``; chunk i covers positions [i chunk, (i + 1)
    chunk), every position < cap lies in exactly one, and none is
    empty.  A kernel skips the chunks at or past a slot's length."""
    units = _cdiv(cap, bs)
    per = _cdiv(units, max_chunks)
    return per * bs, _cdiv(units, per)


def decode_head_groups(h, max_heads=DECODE_MAX_HEADS):
    """Heads a CTA of the decode kernels takes: all ``h`` when they fit
    (a CTA then reads each cache row as one contiguous run), else an
    even share of ``ceil(h / max_heads)`` groups (the last may hold
    fewer)."""
    return _cdiv(h, _cdiv(h, max_heads))


_COUNTERS = {}


def split_workspace(q, chunks, hg, stream):
    """``(acc, ml, counters)`` for a split launch on q's device and
    ``stream``: f32 partials [N, H, chunks, D] and [N, H, chunks, 2]
    from the caching allocator, and the launch's ``N * ceil(H / hg)``
    merge counters, kept per (device, stream) and left at zero by every
    launch (the merging CTA resets its own)."""
    n, h, d = q.shape
    part = torch.empty(n * h * chunks * (d + 2), dtype=torch.float32,
                       device=q.device)
    need = n * _cdiv(h, hg)
    key = (q.device.index, stream)
    cnt = _COUNTERS.get(key)
    if cnt is None or cnt.numel() < need:
        cnt = _COUNTERS[key] = torch.zeros(max(need, 256),
                                           dtype=torch.int32, device=q.device)
    return part, part[n * h * chunks * d:], cnt


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
        if t.data_ptr() % 16:
            raise ValueError("%s: %s must be 16-byte aligned (the kernel "
                             "reads 16 bytes a lane)" % (name, what))
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
    chunk, chunks = decode_split_plan(k_cache.shape[1])
    out = _launch_dense(q, k_cache, v_cache, lengths, scale, chunk, chunks,
                        decode_head_groups(h))
    decode_attention.launches += 1
    return out


def _launch_dense(q, k_cache, v_cache, lengths, scale, chunk, chunks, hg):
    """The dense kernel on an explicit plan (checked operands)."""
    n, h, d = q.shape
    out = torch.empty_like(q)
    stream = _build.stream_ptr(q.device)
    acc, ml, cnt = split_workspace(q, chunks, hg, stream)
    _build.launch("decode_attention", "decode_attention", _DENSE_ARGTYPES,
                  q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  out.data_ptr(), lengths.data_ptr(), acc.data_ptr(),
                  ml.data_ptr(), cnt.data_ptr(), n, h, k_cache.shape[1], d,
                  chunk, chunks, hg, scale, _build.dtype_code(q), stream)
    return out


decode_attention.launches = 0

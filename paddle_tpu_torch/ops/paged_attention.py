"""Attention over a PAGED KV cache (PagedAttention, Kwon et al. 2023).

Counterpart of `paddle_tpu.ops.pallas.paged_attention`.  The store is a
block pool ``[num_blocks, block_size, H, D]`` shared by every slot; a
per-slot table ``[N, max_blocks]`` int32 maps the slot's logical block
j to a pool block.

* `paged_decode_attention` — one query token per slot through the
  table.  CUDA tensors launch the hand-written kernel
  (``csrc/paged_attention.cu``), which shares its body (a split of the
  key range into chunks of whole blocks) with the dense decode kernel
  and is bitwise equal to it on identical contents under the same
  chunk plan (block size 16, the engine's default); any block size
  works.  CPU tensors take the plain version.
* `paged_gather_kv` — the dense ``[N, T, H, D]`` view of each slot's
  blocks (dequantized f32 when the pool is int8 and its scales are
  given).
* `paged_decode_attention_reference` — the plain version: gather, then
  the dense decode reference.
* `chunked_attention_reference` — C query rows per slot over a dense
  cache view with per-row causal limits ``t <= start + i``: the chunked
  prefill and speculative verify math.  The reference computes it in
  jnp outside any Pallas kernel, so it is plain PyTorch here too.

int8 KV: pools may be int8 with per-row per-head f32 scales
``[num_blocks, block_size, H]`` (`quantize_kv` / `dequantize_kv`).  A
quantized pool is read through `paged_decode_attention_reference` with
its scales, on every device, as the reference's dispatch reads it: it
has no int8 kernel.  `paged_decode_attention` refuses an int8 pool.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_attention import (NEG_INF, check_decode_operands,
                               decode_attention_reference,
                               decode_head_groups, decode_split_plan,
                               split_workspace)

__all__ = ["chunked_attention_reference", "dequantize_kv",
           "paged_decode_attention", "paged_decode_attention_reference",
           "paged_gather_kv", "quantize_kv"]

# paged_decode_attention(q, k_pool, v_pool, o, tables, lengths, acc, ml,
#                        counters, N, H, D, bs, max_blocks, chunk, chunks,
#                        hg, scale, dtype, stream)
# in csrc/paged_attention.cu
_PAGED_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def quantize_kv(x, axis=-1):
    """Symmetric int8 quantization of KV rows with per-head scales.

    x [..., H, D] float -> (q int8 [..., H, D], scale f32 [..., H]) where
    ``scale = max(amax(|x|, D) / 127, 1e-8)`` (floored away from zero so
    that an all-zero row round-trips to exact zeros).  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    x = x.float()
    amax = x.abs().amax(dim=axis)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale):
    """Inverse of `quantize_kv`: int8 [..., H, D] * f32 [..., H]."""
    return q.float() * scale[..., None].float()


def paged_gather_kv(pool, tables, scale_pool=None):
    """Dense [N, T, H, D] view of each slot's table-mapped blocks:
    pool [NB, bs, H, D]; tables [N, max_blocks]; T = max_blocks * bs.
    With ``scale_pool`` [NB, bs, H] the pool is int8 and the view is
    dequantized f32."""
    n, nb = tables.shape
    bs, h, d = pool.shape[1], pool.shape[2], pool.shape[3]
    g = pool[tables.long()].reshape(n, nb * bs, h, d)
    if scale_pool is not None:
        g = dequantize_kv(g, scale_pool[tables.long()].reshape(n, nb * bs, h))
    return g


def paged_decode_attention_reference(q, k_pool, v_pool, tables, lengths,
                                     scale=None, k_scale=None, v_scale=None):
    """Plain version: q [N, H, D]; pools [NB, bs, H, D]; tables
    [N, max_blocks]; lengths [N]; int8 pools with their ``k_scale`` /
    ``v_scale`` [NB, bs, H].  Equals the dense decode reference on the
    gathered (dequantized) view."""
    k = paged_gather_kv(k_pool, tables, k_scale)
    v = paged_gather_kv(v_pool, tables, v_scale)
    return decode_attention_reference(q, k, v, lengths, scale)


def chunked_attention_reference(q, k_cache, v_cache, start, n_real=None,
                                scale=None):
    """C query rows per slot over a dense cache view: row i attends cache
    positions ``t <= start + i``.

    q [N, C, H, D]; k/v_cache [N, T, H, D]; start [N] int (the position
    of row 0, whose K/V must already be in the cache, as in the decode
    step's write-then-attend contract).  Scores and the PV product are
    f32; a row with no live position returns 0.  C == 1 equals
    `decode_attention_reference` with ``lengths = start + 1``.  Rows past
    ``n_real`` are padding whose output the caller ignores (the argument
    is accepted for parity with the reference and changes nothing).

    Positions past every row's limit may hold anything (a gathered view
    reads the garbage block there): V is zeroed at them so that a masked
    weight of exactly 0 never meets an inf or NaN."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    c, t = q.shape[1], k_cache.shape[1]
    dev = q.device
    s = torch.einsum("nchd,nthd->nhct", q.float(), k_cache.float()) * scale
    pos = torch.arange(t, device=dev)
    limit = (start.to(dev).long()[:, None]
             + torch.arange(c, device=dev)[None, :])           # [N, C]
    valid = pos[None, None, :] <= limit[:, :, None]            # [N, C, T]
    s = torch.where(valid[:, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    safe_m = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - safe_m))
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.clamp(l, min=1e-30)
    live = pos[None, :] <= limit[:, -1:]                       # [N, T]
    v = torch.where(live[:, :, None, None], v_cache.float(), 0.0)
    out = torch.einsum("nhct,nthd->nchd", p, v)
    dead = (m <= NEG_INF / 2).permute(0, 2, 1, 3)              # [N, C, H, 1]
    return torch.where(dead, 0.0, out).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, tables, lengths, scale=None):
    """One decode step of attention through the block table.

    q [N, H, D]; pools [NB, bs, H, D]; tables [N, max_blocks] int32;
    lengths [N] int32 (positions ``t < lengths[n]`` attended).  Only
    the first ``ceil(lengths[n] / bs)`` table entries of a slot are
    read.  Returns [N, H, D].

    Pools of another dtype than q's raise, on the CPU too: nothing is
    cast silently.  An int8 pool is read through
    `paged_decode_attention_reference` with its scales."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError("paged_decode_attention: pools of %s / %s do not "
                         "fit q of %s (an int8 pool is read through "
                         "paged_decode_attention_reference with its scales)"
                         % (k_pool.dtype, v_pool.dtype, q.dtype))
    if not q.is_cuda:
        return paged_decode_attention_reference(q, k_pool, v_pool, tables,
                                                lengths, scale)
    n, h, d = check_decode_operands("paged_decode_attention", q, k_pool,
                                    v_pool, lengths,
                                    extra=(("tables", tables),))
    if tables.dim() != 2 or tables.shape[0] != n:
        raise ValueError("paged_decode_attention: tables must be [%d, "
                         "max_blocks], got %s" % (n, tuple(tables.shape)))
    bs = k_pool.shape[1]
    chunk, chunks = decode_split_plan(tables.shape[1] * bs, bs)
    out = _launch_paged(q, k_pool, v_pool, tables, lengths, scale, chunk,
                        chunks, decode_head_groups(h))
    paged_decode_attention.launches += 1
    return out


def _launch_paged(q, k_pool, v_pool, tables, lengths, scale, chunk, chunks,
                  hg):
    """The paged kernel on an explicit plan (checked operands; ``chunk``
    a multiple of the block size)."""
    n, h, d = q.shape
    out = torch.empty_like(q)
    stream = _build.stream_ptr(q.device)
    acc, ml, cnt = split_workspace(q, chunks, hg, stream)
    _build.launch("paged_attention", "paged_decode_attention",
                  _PAGED_ARGTYPES, q.data_ptr(), k_pool.data_ptr(),
                  v_pool.data_ptr(), out.data_ptr(), tables.data_ptr(),
                  lengths.data_ptr(), acc.data_ptr(), ml.data_ptr(),
                  cnt.data_ptr(), n, h, d, k_pool.shape[1], tables.shape[1],
                  chunk, chunks, hg, scale, _build.dtype_code(q), stream)
    return out


paged_decode_attention.launches = 0

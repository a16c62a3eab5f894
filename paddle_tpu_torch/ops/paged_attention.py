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
  blocks.
* `paged_decode_attention_reference` — the plain version: gather, then
  the dense decode reference.

Left for the int8 slice: int8 pools with per-row scales (``quantize_kv``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_attention import (check_decode_operands,
                               decode_attention_reference,
                               decode_head_groups, decode_split_plan,
                               split_workspace)

__all__ = ["paged_decode_attention", "paged_decode_attention_reference",
           "paged_gather_kv"]

# paged_decode_attention(q, k_pool, v_pool, o, tables, lengths, acc, ml,
#                        counters, N, H, D, bs, max_blocks, chunk, chunks,
#                        hg, scale, dtype, stream)
# in csrc/paged_attention.cu
_PAGED_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def paged_gather_kv(pool, tables):
    """Dense [N, T, H, D] view of each slot's table-mapped blocks:
    pool [NB, bs, H, D]; tables [N, max_blocks]; T = max_blocks * bs."""
    n, nb = tables.shape
    bs, h, d = pool.shape[1], pool.shape[2], pool.shape[3]
    return pool[tables.long()].reshape(n, nb * bs, h, d)


def paged_decode_attention_reference(q, k_pool, v_pool, tables, lengths,
                                     scale=None):
    """Plain version: q [N, H, D]; pools [NB, bs, H, D]; tables
    [N, max_blocks]; lengths [N].  Equals the dense decode reference on
    the gathered view."""
    k = paged_gather_kv(k_pool, tables)
    v = paged_gather_kv(v_pool, tables)
    return decode_attention_reference(q, k, v, lengths, scale)


def paged_decode_attention(q, k_pool, v_pool, tables, lengths, scale=None):
    """One decode step of attention through the block table.

    q [N, H, D]; pools [NB, bs, H, D]; tables [N, max_blocks] int32;
    lengths [N] int32 (positions ``t < lengths[n]`` attended).  Only
    the first ``ceil(lengths[n] / bs)`` table entries of a slot are
    read.  Returns [N, H, D]."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
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

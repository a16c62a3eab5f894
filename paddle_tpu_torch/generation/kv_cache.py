"""KV caches: the decode step's working set, dense and PAGED.

Counterpart of `paddle_tpu.generation.kv_cache`.

* `KVCache` — the dense layout ``[L, slots, max_len, H, D]`` per array,
  every slot paying ``max_len`` rows; the paged engine's A/B baseline.
* `PagedKVCache` — a block pool ``[L, num_blocks, block_size, H, D]``
  (k and v) every slot draws from, plus a host per-slot block table
  ``[slots, max_blocks_per_slot]`` int32 mapping logical block j to a
  pool block;
* `BlockPool` — the refcounted allocator.  It always hands out the
  LOWEST free block id (a heap), and block 0 is the reserved garbage
  block: inactive slots' table rows point at it, so the batched decode
  step's dead-row writes land somewhere nobody reads.

The device tensors are updated in place by the model (PyTorch has no
donation; in-place writes are what donation bought the JAX engine).
Left for later slices: `PrefixCache` and int8 pools.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["BlockPool", "KVCache", "PagedKVCache", "PoolExhausted"]


class KVCache:
    """Dense cache (see module doc)."""

    def __init__(self, num_layers, slots, max_len, num_heads, head_dim,
                 dtype=torch.float32, device=None):
        self.num_layers = int(num_layers)
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.device = resolve_device(device)
        shape = (self.num_layers, self.slots, self.max_len,
                 self.num_heads, self.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)

    @property
    def shape(self):
        return tuple(self.k.shape)

    @property
    def nbytes(self):
        return int(2 * self.k.numel() * self.k.element_size())

    def arrays(self):
        return self.k, self.v

    def describe(self):
        return {
            "layers": self.num_layers, "slots": self.slots,
            "max_len": self.max_len, "heads": self.num_heads,
            "head_dim": self.head_dim, "dtype": str(self.dtype),
            "bytes": self.nbytes, "paged": False,
        }


class PoolExhausted(RuntimeError):
    """No free block — the engine's preempt/requeue trigger."""


class BlockPool:
    """Refcounted allocator over the pool's block axis (host-side).

    Deterministic: allocation always hands out the LOWEST free block id
    (a heap), so a fixed request schedule produces a fixed block
    layout.  Block 0 is reserved (the garbage block) and never leaves
    the pool."""

    def __init__(self, num_blocks):
        if num_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (block 0 is "
                             "reserved), got %d" % num_blocks)
        self.num_blocks = int(num_blocks)
        self._ref = np.zeros(self.num_blocks, np.int32)
        self._ref[0] = 1                       # garbage block, pinned
        self._free = list(range(1, self.num_blocks))
        heapq.heapify(self._free)

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def used_blocks(self):
        return self.num_blocks - 1 - len(self._free)

    def alloc(self, n):
        """n fresh blocks (refcount 1 each) or `PoolExhausted` — the
        caller decides whether to preempt or shed."""
        if n > len(self._free):
            raise PoolExhausted(
                "need %d blocks, %d free of %d"
                % (n, len(self._free), self.num_blocks))
        ids = [heapq.heappop(self._free) for _ in range(n)]
        for b in ids:
            self._ref[b] = 1
        return ids

    def incref(self, ids):
        for b in ids:
            if self._ref[b] <= 0:
                raise ValueError("incref on free block %d" % b)
            self._ref[b] += 1

    def decref(self, ids):
        """Drop one reference per id; blocks hitting zero return to the
        free list.  Returns the freed ids."""
        freed = []
        for b in ids:
            if b == 0:
                raise ValueError("decref on the reserved garbage block")
            if self._ref[b] <= 0:
                raise ValueError("double free of block %d" % b)
            self._ref[b] -= 1
            if self._ref[b] == 0:
                heapq.heappush(self._free, b)
                freed.append(b)
        return freed

    def refcount(self, block_id):
        return int(self._ref[block_id])


class PagedKVCache:
    """Host-side handle of the paged device pool (see module doc).

    ``num_blocks`` INCLUDES block 0 (the reserved garbage block); the
    usable capacity is ``(num_blocks - 1) * block_size`` token rows."""

    def __init__(self, num_layers, num_blocks, block_size, num_heads,
                 head_dim, slots, max_len, dtype=torch.float32,
                 kv_dtype=None, device=None):
        if kv_dtype is not None:
            raise NotImplementedError(
                "kv_dtype=%r: int8 KV pools are not ported yet" % (kv_dtype,))
        self.num_layers = int(num_layers)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.max_blocks_per_slot = -(-self.max_len // self.block_size)
        self.dtype = dtype
        self.kv_dtype = None
        self.device = resolve_device(device)
        shape = (self.num_layers, self.num_blocks, self.block_size,
                 self.num_heads, self.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.pool = BlockPool(self.num_blocks)
        self.block_tables = np.zeros(
            (self.slots, self.max_blocks_per_slot), np.int32)

    @property
    def shape(self):
        return tuple(self.k.shape)

    @property
    def nbytes(self):
        return int(2 * self.k.numel() * self.k.element_size())

    @property
    def capacity_tokens(self):
        return (self.num_blocks - 1) * self.block_size

    def arrays(self):
        return self.k, self.v

    # -- slot bookkeeping (host) ------------------------------------------
    def blocks_for(self, n_tokens):
        return -(-int(n_tokens) // self.block_size)

    def table_row(self, slot):
        return self.block_tables[slot]

    def assign(self, slot, logical_index, block_id):
        self.block_tables[slot, logical_index] = block_id

    def clear_slot(self, slot):
        """Zero the table row — every entry points back at the garbage
        block.  Reference bookkeeping is the ENGINE's job."""
        self.block_tables[slot, :] = 0

    def describe(self):
        return {
            "layers": self.num_layers, "slots": self.slots,
            "max_len": self.max_len, "heads": self.num_heads,
            "head_dim": self.head_dim, "dtype": str(self.dtype),
            "bytes": self.nbytes, "paged": True,
            "block_size": self.block_size,
            "num_blocks": self.num_blocks,
            "capacity_tokens": self.capacity_tokens,
            "kv_dtype": str(self.dtype),
            "blocks_used": self.pool.used_blocks,
            "blocks_free": self.pool.free_blocks,
        }

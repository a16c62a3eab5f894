"""KV caches: the decode step's working set, dense and PAGED.

Counterpart of `paddle_tpu.generation.kv_cache`.

* `KVCache` — the dense layout ``[L, slots, max_len, H, D]`` per array,
  every slot paying ``max_len`` rows; the paged engine's A/B baseline.
* `PagedKVCache` — a block pool ``[L, num_blocks, block_size, H, D]``
  (k and v) every slot draws from, plus a host per-slot block table
  ``[slots, max_blocks_per_slot]`` int32 mapping logical block j to a
  pool block; with ``kv_dtype="int8"`` the pools are int8 beside f32
  per-row per-head scales ``[L, num_blocks, block_size, H]``;
* `BlockPool` — the refcounted allocator.  It always hands out the
  LOWEST free block id (a heap), and block 0 is the reserved garbage
  block: inactive slots' table rows point at it, so the batched decode
  step's dead-row writes land somewhere nobody reads;
* `PrefixCache` — full-block prefix reuse over the pool: a token-chain
  hash names each full prompt block, the registry holds one reference
  per cached block, and eviction is leaf-first LRU.  Pure host code.

The device tensors are updated in place by the model (PyTorch has no
donation; in-place writes are what donation bought the JAX engine).
"""

from __future__ import annotations

import hashlib
import heapq

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["BlockPool", "KVCache", "PagedKVCache", "PoolExhausted",
           "PrefixCache"]


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


class PrefixCache:
    """Refcounted full-block prefix reuse keyed by a token-chain hash.

    Key of block j = H(key_{j-1} || tokens of block j), sha1 over the
    literal token bytes: a chain, so a lookup walks the prompt's full
    blocks until the first miss and every hit is an exact token-prefix
    match (hash collisions aside).  The registry holds one pool
    reference per cached block; each slot using a block holds another,
    so a shared block frees only when the last user AND the registry
    let go.  Eviction is LRU over chains with no registry children and
    no outside users, triggered by allocation pressure."""

    def __init__(self, pool, block_size):
        self.pool = pool
        self.block_size = int(block_size)
        # key -> [block_id, parent_key, last_use, n_child]
        self._entries = {}
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0

    def __len__(self):
        return len(self._entries)

    @staticmethod
    def _key(parent, tokens):
        h = hashlib.sha1()
        h.update(parent.encode() if parent else b"root")
        h.update(np.asarray(tokens, np.int64).tobytes())
        return h.hexdigest()

    def _chain_keys(self, prompt_ids, max_tokens):
        """Keys of the full blocks covering <= max_tokens prompt tokens,
        in order."""
        bs = self.block_size
        keys, parent = [], ""
        for j in range(max_tokens // bs):
            parent = self._key(parent, prompt_ids[j * bs:(j + 1) * bs])
            keys.append(parent)
        return keys

    def lookup(self, prompt_ids):
        """Longest cached prefix of ``prompt_ids``, capped one token short
        of the full prompt (a hit must still leave >= 1 token to prefill:
        its logits seed generation).  Returns ``(n_tokens, block_ids)``
        with one pool reference taken per returned block (the caller's
        to decref on release)."""
        keys = self._chain_keys(prompt_ids, len(prompt_ids) - 1)
        blocks = []
        for key in keys:
            ent = self._entries.get(key)
            if ent is None:
                break
            self._clock += 1
            ent[2] = self._clock
            blocks.append(ent[0])
        if blocks:
            self.pool.incref(blocks)
            self.hits += 1
            self.hit_tokens += len(blocks) * self.block_size
        else:
            self.misses += 1
        return len(blocks) * self.block_size, blocks

    def register(self, prompt_ids, block_ids):
        """Publish a prefilled prompt's FULL blocks.  The registry increfs
        what it adopts; prefixes already registered (the ones this
        request was served from among them) are left alone."""
        keys = self._chain_keys(prompt_ids, len(prompt_ids))
        parent = ""
        for j, key in enumerate(keys):
            if key not in self._entries:
                self._clock += 1
                self.pool.incref([block_ids[j]])
                self._entries[key] = [block_ids[j], parent, self._clock, 0]
                if parent:
                    self._entries[parent][3] += 1
            parent = key

    def evict(self, n_blocks_needed):
        """Free LRU chains (leaf-first, registry-only references) until
        ``n_blocks_needed`` blocks are free or nothing evictable is left.
        Returns the number of blocks actually freed."""
        freed = 0
        while self.pool.free_blocks < n_blocks_needed:
            victims = [
                (ent[2], key) for key, ent in self._entries.items()
                if ent[3] == 0 and self.pool.refcount(ent[0]) == 1
            ]
            if not victims:
                break
            _, key = min(victims)
            ent = self._entries.pop(key)
            if ent[1]:
                self._entries[ent[1]][3] -= 1
            freed += len(self.pool.decref([ent[0]]))
        return freed

    def stats(self):
        total = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "hits": self.hits, "misses": self.misses,
            "hit_rate": (self.hits / total) if total else 0.0,
            "hit_tokens": self.hit_tokens,
        }


class PagedKVCache:
    """Host-side handle of the paged device pool (see module doc).

    ``num_blocks`` INCLUDES block 0 (the reserved garbage block); the
    usable capacity is ``(num_blocks - 1) * block_size`` token rows.
    ``kv_dtype="int8"`` stores the pools quantized (`ops.quantize_kv`)
    with their scales; ``dtype`` is then the model's, not the store's."""

    def __init__(self, num_layers, num_blocks, block_size, num_heads,
                 head_dim, slots, max_len, dtype=torch.float32,
                 kv_dtype=None, device=None):
        if kv_dtype not in (None, "int8"):
            raise ValueError("kv_dtype must be None or 'int8', got %r"
                             % (kv_dtype,))
        self.num_layers = int(num_layers)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.max_blocks_per_slot = -(-self.max_len // self.block_size)
        self.dtype = dtype
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == "int8"
        self.device = resolve_device(device)
        shape = (self.num_layers, self.num_blocks, self.block_size,
                 self.num_heads, self.head_dim)
        store = torch.int8 if self.quantized else dtype
        self.k = torch.zeros(shape, dtype=store, device=self.device)
        self.v = torch.zeros(shape, dtype=store, device=self.device)
        if self.quantized:
            self.k_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=self.device)
            self.v_scale = torch.zeros_like(self.k_scale)
        else:
            self.k_scale = self.v_scale = None
        self.pool = BlockPool(self.num_blocks)
        self.block_tables = np.zeros(
            (self.slots, self.max_blocks_per_slot), np.int32)

    @property
    def shape(self):
        return tuple(self.k.shape)

    @property
    def nbytes(self):
        return sum(int(a.numel() * a.element_size()) for a in self.arrays())

    @property
    def capacity_tokens(self):
        return (self.num_blocks - 1) * self.block_size

    def arrays(self):
        """The device tensors, in the model's cache-tuple order: ``(k,
        v)``, or ``(k, v, k_scale, v_scale)`` for an int8 pool."""
        if self.quantized:
            return self.k, self.v, self.k_scale, self.v_scale
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
            "kv_dtype": self.kv_dtype or str(self.dtype),
            "blocks_used": self.pool.used_blocks,
            "blocks_free": self.pool.free_blocks,
        }

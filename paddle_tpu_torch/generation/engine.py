"""`GenerationEngine`: slot-based continuous-batching autoregressive
decoding (Orca-style iteration-level scheduling) over a PAGED KV cache.

Counterpart of `paddle_tpu.generation.engine`, run eagerly in PyTorch:

* **prefill** — a new request claims a free cache slot, its prompt is
  padded to a bucket from the prefill ladder, and ONE causal forward on
  the flash kernel computes the logits and every layer's K/V; the K/V
  rows scatter through the slot's BLOCK TABLE into the pool, and the
  first token is sampled from the last real position — the TTFT path.
* **decode** — every scheduler iteration runs ONE step over ALL slots:
  one token per slot in, K/V written through the block table, attention
  through the paged decode kernel, one sampled token per slot out.
* **paged KV** — the store is a block pool ``[L, num_blocks, block_size,
  H, D]`` plus a host per-slot block table (`kv_cache.PagedKVCache`).
  Slots allocate blocks as they grow; when the pool runs dry the engine
  evicts cached prefixes, then preempts the least-progressed slot
  (restart semantics) rather than crashing.  ``paged=False`` keeps the
  dense layout as the A/B baseline, decoding through the dense kernel.
* **prefix caching** — with ``prefix_cache=True``, full prompt blocks
  are published under a token-chain hash (`kv_cache.PrefixCache`).  A
  new request sharing a cached prefix adopts those blocks by reference
  and prefills only the suffix.  Only FULL blocks are shared, so the
  writable tail is private and copy-on-write never arises.
* **chunked prefill** — ``prefill_chunk=C`` feeds prompts through
  C-token chunks, ONE chunk a slot per scheduler iteration, so decode
  steps of running requests interleave with a long prefill; a prefix
  hit's suffix rides the same path as one chunk of its ladder bucket.
  A chunk is one model call that writes its rows into the slot's blocks
  and attends row i over positions ``<= start + i``
  (`ops.chunked_attention_reference`, plain PyTorch, as the reference's
  jnp function is).
* **logprobs** — with ``logprobs=True`` every token event carries the
  token's log-probability under the raw logits
  (`sampling.token_logprobs`), and `RequestHandle.logprobs` returns
  them.
* **int8 KV** — ``kv_dtype="int8"`` stores the pool quantized with
  per-row per-head scales (`ops.quantize_kv`).  Decode reads the
  dequantized gather (`ops.paged_decode_attention_reference` with the
  scales, plain PyTorch on every device, as the reference's dispatch
  does: it has no int8 kernel).  Opt-in under a documented tolerance: logits move
  within quantization error, so streams may differ from the f32
  engine's.
* **speculative decoding** — with ``draft_model`` and ``draft_len=k``,
  a small draft LM with its own dense cache proposes k greedy tokens
  (decode steps of the draft, the dense decode kernel; one more step
  writes the last proposal's row, which the reference leaves
  unwritten), and ONE verify call of the target scores all k + 1
  positions over the paged cache (the chunk path).  Greedy slots accept
  the longest draft prefix the target agrees with plus the target's
  correction token, so their streams are the target's own greedy
  streams; sampled slots take row 0 only, sampled at their own step, so
  their streams stay those of plain decode.

Exactness: scheduling is invisible in the tokens.  Per-request random
streams (`sampling.py`) and row-independent slot math make the output
token-for-token identical to serving the same requests one at a time
(`sequential_oracle`, built with the same knobs: the same chunk
boundaries give the same shapes); paged and dense engines prefill
through the same forward and decode through kernels that are bitwise
equal on the card.

The serving tier's API (`serving.GenerationFleet`,
`tp_serving.DisaggPair`):

* **death** — `kill()` or a step hook raising `EngineDeadError`
  collects the handles in flight, chunking or queued
  (`affected_on_death`); an ``on_death(engine, handles)`` hook takes
  them (the fleet requeues each once), else they fail;
* **request window** — every per-request record is kept in a window of
  the last 256 (`recent_requests`) and forwarded to ``request_sink``;
* **weight swap** — `snapshot_params` / `swap_params` read and replace
  the serving weights (the model's ``state_dict`` names and layout)
  under the engine lock, between two steps.  Engines built from one
  module share it until their first swap, which gives the swapping
  engine its own copy built from the new tensors (copy-on-swap): a swap
  never reaches another engine or the caller's model, and the decode
  step gains no work;
* **disaggregated prefill / decode** — `prefill_extract` runs one
  whole-prompt prefill and lifts the slot's pages into a
  `tp_serving.KVHandoff`; `inject_prefilled` queues one for a decode
  engine, which copies the pages into fresh blocks and decodes without
  ever running a prefill;
* **launch signatures** — PyTorch compiles nothing, so where the
  reference counts the executables each jitted path compiled,
  `stats()["executables"]` counts the distinct launch signatures
  (shapes and dtypes of the model call's inputs) each path has run:
  one decode step signature an engine, one a prefill bucket used.

The device cache is updated in place, so ``donate`` has nothing to
select and is accepted for signature parity only.
"""

from __future__ import annotations

import copy
import itertools
import math
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from ..device import resolve_device
from ..observability import locks as _locks
from ..observability import trace as _trace
from ..observability.metrics import default_registry, unique_instance_label
from ..ops.paged_attention import quantize_kv
from .kv_cache import KVCache, PagedKVCache, PoolExhausted, PrefixCache
from .sampling import SamplingParams, sample_tokens, token_logprobs

__all__ = [
    "EngineDeadError",
    "GenerationEngine",
    "GenerationRequest",
    "RequestHandle",
    "ShedError",
    "default_prefill_buckets",
    "sequential_oracle",
]


class EngineDeadError(RuntimeError):
    """The engine died mid-generation (injected drill death or a loop
    crash) — affected requests were NOT completed."""


class ShedError(RuntimeError):
    """Request refused at admission.  `reason` is the policy that fired;
    `retry_after_s` is the integer seconds for the Retry-After header.
    `serving.admission` exports this same class, so the fleet catches
    what the engine raises."""

    def __init__(self, reason, retry_after_s=1, detail=""):
        self.reason = reason
        self.retry_after_s = max(1, int(math.ceil(retry_after_s)))
        super().__init__(
            "request shed (%s)%s; retry after %ds"
            % (reason, (": " + detail) if detail else "", self.retry_after_s))


def _entry_request(entry):
    """Pending-queue entries are `GenerationRequest`s or
    `tp_serving.KVHandoff`s (which carry one)."""
    return entry if isinstance(entry, GenerationRequest) \
        else entry.request


def _signature(*inputs):
    """The launch signature of one model call: its inputs' shapes and
    dtypes (the port's stand-in for a jitted executable's identity)."""
    return tuple((tuple(t.shape), t.dtype) for t in inputs)


def default_prefill_buckets(max_len):
    """Power-of-two prompt-length ladder up to max_len."""
    out = []
    b = 8
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


class GenerationRequest:
    """One prompt in, one token stream out."""

    _ids = itertools.count()

    def __init__(self, prompt_ids, max_new_tokens=16, sampling=None,
                 stop_token_ids=(), request_id=None):
        self.prompt_ids = [int(t) for t in np.asarray(prompt_ids).ravel()]
        if not self.prompt_ids:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.sampling = sampling or SamplingParams.greedy()
        self.stop_token_ids = frozenset(int(t) for t in stop_token_ids)
        self.request_id = (request_id if request_id is not None
                           else "genreq-%d" % next(self._ids))


class RequestHandle:
    """The caller's end of one request: a stream of ``(index, token)``
    plus terminal events (``("token", index, token, logprob)`` on an
    engine built with ``logprobs=True``).  ``restart`` events (the
    fleet's requeue after a replica death and preemption on pool
    exhaustion both re-run the request from scratch) reset the index
    stream to 0; a consumer discards what it saw before.  ``requeued``
    is the fleet's requeue-once latch."""

    def __init__(self, request, trace=None):
        self.request = request
        self._q = queue.Queue()
        self._done = threading.Event()
        self._tokens = []
        self._logprobs = []            # filled only on logprob engines
        self.finish_reason = None
        self.error = None
        self.requeued = False
        self.t_submit = time.perf_counter()
        self.t_first_token = None
        self.t_tokens = []             # host clock at each token's delivery
        self.trace = trace if trace is not None else _trace.TraceContext()
        self._sink = None              # engine's per-request record sink

    # -- engine side ------------------------------------------------------
    def _emit(self, index, token, logprob=None):
        now = time.perf_counter()
        if index == 0:
            self.t_first_token = now
        self._tokens.append(int(token))
        self.t_tokens.append(now)
        tr = _trace.default_tracer()
        if tr.enabled:
            tr.async_instant("token", self.trace.trace_id,
                             cat="generation", args={"index": index})
        if logprob is None:
            # logprobs off: the event is the 3-tuple of an engine
            # without the knob
            self._q.put(("token", index, int(token)))
        else:
            self._logprobs.append(float(logprob))
            self._q.put(("token", index, int(token), float(logprob)))

    def _restart(self):
        self._tokens = []
        self._logprobs = []
        self.t_tokens = []
        tr = _trace.default_tracer()
        if tr.enabled:
            tr.async_instant("restart", self.trace.trace_id,
                             cat="generation")
        self._q.put(("restart", None, None))

    def _finish(self, reason):
        self.finish_reason = reason
        self._record("ok", reason=reason)
        tr = _trace.default_tracer()
        if tr.enabled:
            tr.async_end("request", self.trace.trace_id,
                         cat="generation", args={"reason": reason})
        self._q.put(("done", reason, None))
        self._done.set()

    def _fail(self, error):
        self.error = str(error)
        self._record("error", error=str(error))
        tr = _trace.default_tracer()
        if tr.enabled:
            tr.async_end("request", self.trace.trace_id,
                         cat="generation", args={"error": str(error)})
        self._q.put(("error", str(error), None))
        self._done.set()

    def _record(self, outcome, **extra):
        """Build + sink the per-request SLO record."""
        now = time.perf_counter()
        n = len(self._tokens)
        ttft = ((self.t_first_token - self.t_submit) * 1e3
                if self.t_first_token is not None else None)
        itl = ((now - self.t_first_token) * 1e3 / (n - 1)
               if n > 1 and self.t_first_token is not None else None)
        rec = {"request_id": self.request.request_id,
               "trace_id": self.trace.trace_id,
               "t_wall": time.time(),
               "outcome": outcome,
               "ttft_ms": ttft,
               "itl_ms": itl,
               "n_tokens": n,
               "duration_ms": (now - self.t_submit) * 1e3}
        rec.update(extra)
        sink = self._sink
        if sink is not None:
            try:
                sink(rec)
            except Exception:
                pass
        return rec

    # -- caller side ------------------------------------------------------
    def events(self, timeout=30.0):
        """Yield raw events until the terminal ("done", reason) /
        ("error", msg), which is yielded last; raises TimeoutError when
        one event takes longer than ``timeout``."""
        while True:
            try:
                ev = self._q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    "request %s produced no event within %.1fs"
                    % (self.request.request_id, timeout)) from None
            yield ev
            if ev[0] in ("done", "error"):
                return

    def tokens(self, timeout=30.0):
        """Yield ``(index, token)``; restart resets the stream."""
        for ev in self.events(timeout=timeout):
            if ev[0] == "token":
                yield ev[1], ev[2]
            elif ev[0] == "error":
                raise RuntimeError(ev[1])

    def result(self, timeout=30.0):
        """Block until done; the complete generated token list."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                "request %s not finished" % self.request.request_id)
        if self.error is not None:
            raise RuntimeError(self.error)
        return list(self._tokens)

    def logprobs(self, timeout=30.0):
        """Block until done; the generated tokens' log-probabilities
        (`sampling.token_logprobs`).  Empty unless the engine was built
        with ``logprobs=True``."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                "request %s not finished" % self.request.request_id)
        if self.error is not None:
            raise RuntimeError(self.error)
        return list(self._logprobs)

    @property
    def done(self):
        return self._done.is_set()


class _Slot:
    __slots__ = ("request", "handle", "generated")

    def __init__(self, request, handle):
        self.request = request
        self.handle = handle
        self.generated = 0


class _ChunkState:
    """A slot mid-way through chunked prefill (not yet decoding)."""

    __slots__ = ("request", "handle", "pos", "t0")

    def __init__(self, request, handle, pos, t0):
        self.request = request
        self.handle = handle
        self.pos = pos                 # prompt tokens already in cache
        self.t0 = t0


class GenerationEngine:
    """See module docstring.

    ``model`` is a `models.TransformerLM` (or anything with its forward
    contract and a ``cfg``); the engine moves it to ``device`` (default:
    the card; raises when there is none) and into eval mode, and serves
    it shared until its first `swap_params`.
    ``slots`` x ``max_len`` sizes the cache; ``prefill_buckets`` is the
    prompt-length ladder (default: pow2).  ``max_queue`` bounds the
    pending queue — beyond it `submit` sheds (`ShedError`).
    ``step_hook(step_no)`` runs before every decode step (the drills'
    kill seam: raising `EngineDeadError` there kills the engine).

    Paged knobs: ``paged`` (default True) selects the block pool;
    ``block_size`` is its row granularity; ``kv_blocks`` sizes it
    (default: dense parity — ``slots * ceil(max_len / block_size) + 1``;
    provision below that and preemption absorbs the tail).
    ``prefix_cache`` enables full-block prefix reuse and
    ``prefill_chunk`` chunk-prefills prompts C tokens per scheduler
    iteration; ``kv_dtype="int8"`` quantizes the pool; ``draft_model``
    (moved to ``device``, eval mode) with ``draft_len`` >= 1 enables
    speculative decoding (all four need ``paged``); ``logprobs`` adds
    each token's log-probability to its event."""

    def __init__(self, model, *, slots=4, max_len=256,
                 prefill_buckets=None, max_queue=64, name="gen",
                 metrics_registry=None, step_hook=None, donate=None,
                 logprobs=False, paged=True, block_size=16,
                 kv_blocks=None, prefix_cache=False, prefill_chunk=None,
                 kv_dtype=None, draft_model=None, draft_len=0,
                 request_sink=None, device=None):
        cfg = model.cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.return_logprobs = bool(logprobs)
        self.slots = int(slots)
        self.max_len = int(max_len)
        if self.max_len > cfg.max_position_embeddings:
            raise ValueError(
                "max_len %d exceeds the model's max_position_embeddings %d"
                % (self.max_len, cfg.max_position_embeddings))
        self.prefill_buckets = sorted(
            int(b) for b in (prefill_buckets
                             or default_prefill_buckets(self.max_len)))
        if self.prefill_buckets[-1] > self.max_len:
            raise ValueError("prefill bucket %d exceeds max_len %d"
                             % (self.prefill_buckets[-1], self.max_len))
        self.max_queue = int(max_queue)
        self.paged = bool(paged)
        if not self.paged and (prefix_cache or prefill_chunk
                               or kv_dtype is not None):
            raise ValueError("prefix_cache / prefill_chunk / kv_dtype "
                             "require paged=True")
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        dtype = self.model.word.weight.dtype
        n = self.slots
        if self.paged:
            self.block_size = int(block_size)
            mbps = -(-self.max_len // self.block_size)
            if kv_blocks is None:
                kv_blocks = n * mbps + 1        # dense-parity capacity
            self.cache = PagedKVCache(
                cfg.num_layers, int(kv_blocks), self.block_size,
                cfg.num_heads, cfg.head_dim, n, self.max_len, dtype=dtype,
                kv_dtype=kv_dtype, device=self.device)
            self._slot_blocks = [[] for _ in range(n)]
            self._prefix = (PrefixCache(self.cache.pool, self.block_size)
                            if prefix_cache else None)
        else:
            self.block_size = None
            self.cache = KVCache(cfg.num_layers, n, self.max_len,
                                 cfg.num_heads, cfg.head_dim, dtype=dtype,
                                 device=self.device)
            self._slot_blocks = None
            self._prefix = None
        # speculative decoding: the draft proposes, one verify call scores
        self.draft_len = int(draft_len) if draft_model is not None else 0
        self.draft_model = draft_model if self.draft_len > 0 else None
        if draft_model is not None and draft_len < 1:
            raise ValueError("draft_model needs draft_len >= 1")
        if self.draft_model is not None and not self.paged:
            raise ValueError("speculative decoding requires paged=True")
        self._draft_cache = None
        if self.draft_model is not None:
            dcfg = self.draft_model.cfg
            if self.max_len > dcfg.max_position_embeddings:
                raise ValueError("draft model max_position_embeddings %d "
                                 "< engine max_len %d"
                                 % (dcfg.max_position_embeddings,
                                    self.max_len))
            self.draft_model = self.draft_model.to(self.device).eval()
            self._draft_cache = KVCache(
                dcfg.num_layers, n, self.max_len, dcfg.num_heads,
                dcfg.head_dim, dtype=self.draft_model.word.weight.dtype,
                device=self.device)
        # host mirrors of per-slot state (device state is ONLY the cache)
        self._lengths = np.zeros(n, np.int32)
        self._last_tokens = np.zeros(n, np.int64)
        self._steps = np.zeros(n, np.int64)
        self._seeds = np.zeros(n, np.int64)
        self._temp = np.zeros(n, np.float32)
        self._top_k = np.zeros(n, np.int64)
        self._top_p = np.ones(n, np.float32)
        self._active = np.zeros(n, bool)
        self._slot_state = [None] * n          # _Slot | None
        self._chunking = [None] * n            # _ChunkState | None
        self._free = list(range(n))
        self._pending = []                     # [(request, handle)]
        self._lock = _locks.named_rlock("generation.engine",
                                        level="engine")
        # the work-available condition SHARES the engine lock
        self._work = _locks.named_condition(
            "generation.engine", lock=self._lock)
        self._dead = False
        self._stop = False
        self._thread = None
        self._decode_steps = 0
        self._step_hook = step_hook
        self.on_death = None           # fleet requeue hook
        self._affected_on_death = []
        self._t0 = time.perf_counter()
        # per-request records: a bounded local window plus the optional
        # forwarding sink (the fleet's SLOEngine.record)
        self._request_sink = request_sink
        self._recent = deque(maxlen=256)
        # False while self.model is the module the engine was given
        # (shared with its other users); True after the first swap
        self._owns_model = False
        # launch signatures by path, read by stats()["executables"]
        self._sigs = {"decode_step": set(),
                      "prefill": {b: set() for b in self.prefill_buckets},
                      "chunk": {}}
        if self.draft_model is not None:
            self._sigs.update(
                verify=set(), draft_decode=set(),
                draft_prefill={b: set() for b in self.prefill_buckets})

        reg = metrics_registry or default_registry()
        self.metrics_registry = reg
        self._engine = unique_instance_label(name)
        lbl = ("engine",)
        self._m_requests = reg.counter(
            "generation_requests_total", "Submitted generation requests",
            labelnames=lbl).labels(self._engine)
        self._m_tokens = reg.counter(
            "generation_tokens_total", "Generated tokens",
            labelnames=lbl).labels(self._engine)
        self._m_shed = reg.counter(
            "generation_shed_total", "Requests refused at admission",
            labelnames=("engine", "reason"))
        self._m_ttft = reg.histogram(
            "generation_ttft_ms", "Submit -> first token (ms)",
            labelnames=lbl).labels(self._engine)
        self._m_itl = reg.histogram(
            "generation_itl_ms", "Inter-token latency per decode step (ms)",
            labelnames=lbl).labels(self._engine)
        self._m_prefill_ms = reg.histogram(
            "generation_prefill_ms", "Prefill call wall time (ms)",
            labelnames=lbl).labels(self._engine)
        self._m_occupancy = reg.gauge(
            "generation_slot_occupancy", "Occupied-slot fraction",
            labelnames=lbl).labels(self._engine)
        self._m_queue = reg.gauge(
            "generation_queue_depth", "Pending (unslotted) requests",
            labelnames=lbl).labels(self._engine)
        self._m_preempt = reg.counter(
            "generation_preempt_total",
            "Slots preempted on KV pool exhaustion",
            labelnames=lbl).labels(self._engine)
        if self.paged:
            self._m_blocks_used = reg.gauge(
                "generation_kv_blocks_used", "KV pool blocks in use",
                labelnames=lbl).labels(self._engine)
            self._m_blocks_free = reg.gauge(
                "generation_kv_blocks_free", "KV pool blocks free",
                labelnames=lbl).labels(self._engine)
        if self._prefix is not None:
            self._m_prefix_hits = reg.counter(
                "generation_prefix_hits_total",
                "Prefill prefix-cache hits", labelnames=lbl).labels(
                    self._engine)
            self._m_prefix_misses = reg.counter(
                "generation_prefix_misses_total",
                "Prefill prefix-cache misses", labelnames=lbl).labels(
                    self._engine)
            self._m_prefix_tokens = reg.counter(
                "generation_prefix_hit_tokens_total",
                "Prompt tokens served from the prefix cache",
                labelnames=lbl).labels(self._engine)
        if self.draft_model is not None:
            self._m_spec_proposed = reg.counter(
                "generation_spec_proposed_total",
                "Draft tokens proposed to greedy slots",
                labelnames=lbl).labels(self._engine)
            self._m_spec_accepted = reg.counter(
                "generation_spec_accepted_total",
                "Draft tokens accepted by the verify step",
                labelnames=lbl).labels(self._engine)

    # -- block accounting (paged) -----------------------------------------
    def _set_block_gauges(self):
        self._m_blocks_used.set(self.cache.pool.used_blocks)
        self._m_blocks_free.set(self.cache.pool.free_blocks)

    def _ensure_blocks(self, slot, n_tokens):
        """Grow the slot's table to cover ``n_tokens`` cache rows.  Falls
        back to prefix-cache eviction under pool pressure; False when the
        pool is dry even then (the caller preempts/sheds)."""
        need = self.cache.blocks_for(n_tokens) - len(self._slot_blocks[slot])
        if need <= 0:
            return True
        try:
            ids = self.cache.pool.alloc(need)
        except PoolExhausted:
            if self._prefix is not None:
                self._prefix.evict(need)
            try:
                ids = self.cache.pool.alloc(need)
            except PoolExhausted:
                return False
        base = len(self._slot_blocks[slot])
        for j, b in enumerate(ids):
            self.cache.assign(slot, base + j, b)
        self._slot_blocks[slot].extend(ids)
        self._set_block_gauges()
        return True

    def _release_blocks(self, slot):
        """Drop the slot's reference on every block it holds (shared
        prefix blocks stay alive under the registry's reference) and
        point its table row back at the garbage block."""
        ids = self._slot_blocks[slot]
        if ids:
            self.cache.pool.decref(ids)
            self._slot_blocks[slot] = []
        self.cache.clear_slot(slot)
        self._set_block_gauges()

    def _preempt_slot(self, slot, why):
        """Pool-pressure eviction of a running request: every block
        returns to the pool and the request restarts from the front of
        the queue (the handle's stream resets).  A slot mid-chunk goes
        the same way."""
        st = self._slot_state[slot] or self._chunking[slot]
        self._slot_state[slot] = self._chunking[slot] = None
        self._active[slot] = False
        self._release_blocks(slot)
        self._free.append(slot)
        st.handle._restart()
        self._pending.insert(0, (st.request, st.handle))
        self._m_queue.set(len(self._pending))
        self._m_preempt.inc()
        _trace.instant("generation.preempt", cat="generation",
                       args={"slot": int(slot), "why": why,
                             "request_id": st.request.request_id})

    def _grow_or_preempt(self, slot, n_tokens):
        """Grow ``slot`` to ``n_tokens`` rows, preempting the least-
        progressed OTHER slot (fewest generated tokens, a slot mid-chunk
        counting 0, then lowest id) until it fits; False when no victim
        is left."""
        while not self._ensure_blocks(slot, n_tokens):
            victims = [s for s in range(self.slots)
                       if s != slot and (self._slot_state[s] is not None
                                         or self._chunking[s] is not None)]
            if not victims:
                return False

            def progress(s):
                st = self._slot_state[s]
                return (st.generated if st is not None else 0, s)

            self._preempt_slot(min(victims, key=progress), "pool_exhausted")
        return True

    def _fail_slot(self, slot, msg):
        st = self._slot_state[slot]
        self._slot_state[slot] = None
        self._active[slot] = False
        if self.paged:
            self._release_blocks(slot)
        self._free.append(slot)
        st.handle._fail(msg)

    def _decode_tables(self):
        """The table operand for batched decode: rows of slots that are
        NOT decoding are zeroed so their dead-row writes land in the
        reserved garbage block (a mid-chunk slot's real blocks must
        never take a stale-position decode write)."""
        return np.where(self._active[:, None], self.cache.block_tables,
                        0).astype(np.int32)

    # -- admission / submission -------------------------------------------
    def submit(self, request, _handle=None):
        """Queue a request; returns its `RequestHandle`.  Sheds
        (`ShedError`, reason ``slots_full``) when the pending queue is
        at ``max_queue``; refuses requests that can never fit.
        ``_handle`` re-attaches an existing handle (the fleet's requeue
        after a replica death: the stream restarts, the handle stays)."""
        if not isinstance(request, GenerationRequest):
            request = GenerationRequest(request)
        if len(request.prompt_ids) > self.prefill_buckets[-1]:
            raise ValueError(
                "prompt length %d exceeds the largest prefill bucket %d"
                % (len(request.prompt_ids), self.prefill_buckets[-1]))
        need = len(request.prompt_ids) + request.max_new_tokens
        if need > self.max_len:
            raise ValueError(
                "prompt + max_new_tokens = %d exceeds max_len %d"
                % (need, self.max_len))
        if self.paged and \
                self.cache.blocks_for(need) > self.cache.num_blocks - 1:
            raise ValueError(
                "request needs %d blocks, pool has %d usable"
                % (self.cache.blocks_for(need), self.cache.num_blocks - 1))
        with self._lock:
            if self._dead:
                raise EngineDeadError("engine %s is dead" % self._engine)
            if len(self._pending) >= self.max_queue:
                err = ShedError(
                    "slots_full", self._retry_after_locked(),
                    "all %d slots busy and %d requests queued"
                    % (self.slots, len(self._pending)))
                self._m_shed.labels(self._engine, err.reason).inc()
                self._record_request({
                    "request_id": request.request_id, "trace_id": None,
                    "t_wall": time.time(), "outcome": "shed",
                    "ttft_ms": None, "itl_ms": None, "n_tokens": 0,
                    "duration_ms": 0.0})
                raise err
            handle = _handle if _handle is not None \
                else RequestHandle(request)
            handle._sink = self._record_request
            tr = _trace.default_tracer()
            if tr.enabled:
                tid = handle.trace.trace_id
                if _handle is not None:
                    # requeue after a death: the same trace id, so death,
                    # requeue and restart land on one track
                    tr.async_instant("requeue", tid, cat="generation",
                                     args={"engine": self._engine})
                else:
                    tr.async_begin("request", tid, cat="generation",
                                   args={"request_id": request.request_id})
                tr.async_begin("queue", tid, cat="generation")
            self._pending.append((request, handle))
            self._m_requests.inc()
            self._m_queue.set(len(self._pending))
            self._work.notify_all()
        return handle

    def _retry_after_locked(self):
        """Queue depth priced in measured generation throughput."""
        elapsed = time.perf_counter() - self._t0
        rate = self._m_tokens.value / elapsed if elapsed > 0 else 0.0
        if rate <= 0:
            return 1
        backlog = sum(_entry_request(e).max_new_tokens
                      for e, _ in self._pending) or 1
        return max(1.0, backlog / rate)

    def _record_request(self, rec):
        """Sink for per-request SLO records: stamp the engine, keep the
        bounded window and forward to ``request_sink``.  Never raises
        into the serving path."""
        rec = dict(rec, engine=self._engine)
        self._recent.append(rec)
        sink = self._request_sink
        if sink is not None:
            try:
                sink(rec)
            except Exception:
                pass

    def recent_requests(self):
        """The last 256 per-request records, oldest first."""
        return list(self._recent)

    # -- scheduler ---------------------------------------------------------
    def step(self):
        """One scheduler iteration: advance every chunked prefill in
        flight by ONE chunk, refill free slots (prefill), then one decode
        step over the active batch.  Returns True when any work
        happened."""
        with self._lock:
            if self._dead:
                raise EngineDeadError("engine %s is dead" % self._engine)
            progressed = False
            for slot in range(self.slots):
                if self._chunking[slot] is not None:
                    self._chunk_step(slot)
                    progressed = True
            while self._free and self._pending:
                entry, handle = self._pending.pop(0)
                slot = self._free.pop(0)
                self._m_queue.set(len(self._pending))
                tr = _trace.default_tracer()
                if tr.enabled:
                    tr.async_end("queue", handle.trace.trace_id,
                                 cat="generation")
                # a request prefills here; a KVHandoff from a prefill
                # engine brings its pages (a decode engine never
                # prefills it)
                admit = (self._prefill_into
                         if isinstance(entry, GenerationRequest)
                         else self._inject_into)
                if not admit(slot, entry, handle):
                    # pool dry at admission: requeue and wait for a
                    # running request to free blocks — unless nothing
                    # is running, in which case it never will
                    self._free.insert(0, slot)
                    if self._active.any() or any(
                            c is not None for c in self._chunking):
                        self._pending.insert(0, (entry, handle))
                        self._m_queue.set(len(self._pending))
                        if tr.enabled:
                            tr.async_begin("queue", handle.trace.trace_id,
                                           cat="generation")
                    else:
                        handle._fail(
                            "kv pool exhausted: request %s needs more "
                            "blocks than the pool can ever free"
                            % _entry_request(entry).request_id)
                    break
                progressed = True
            if self._active.any():
                self._decode_once()
                progressed = True
            self._m_occupancy.set(
                float(self._active.sum()) / max(self.slots, 1))
            return progressed

    def run_until_idle(self, max_steps=100000):
        """Drive `step()` until no pending and no active work is left."""
        for _ in range(max_steps):
            if not self.step():
                return
        raise RuntimeError("run_until_idle: still busy after %d steps"
                           % max_steps)

    def _bucket_for(self, n):
        for b in self.prefill_buckets:
            if n <= b:
                return b
        raise ValueError("prompt length %d exceeds bucket ladder" % n)

    # -- prefill -----------------------------------------------------------
    def _prefill_into(self, slot, request, handle):
        """Claim blocks and start the prompt.  A prefix hit, or any prompt
        when ``prefill_chunk`` is set, goes to the chunk path; the rest
        runs the whole-prompt flash prefill (`_flash_prefill`).  Returns
        False (nothing claimed) when the pool is dry."""
        sp = request.sampling
        n_prompt = len(request.prompt_ids)
        if self.paged:
            n_cached, shared = 0, []
            if self._prefix is not None:
                n_cached, shared = self._prefix.lookup(request.prompt_ids)
                if n_cached:
                    self._m_prefix_hits.inc()
                    self._m_prefix_tokens.inc(n_cached)
                else:
                    self._m_prefix_misses.inc()
            for j, b in enumerate(shared):
                self.cache.assign(slot, j, b)
            self._slot_blocks[slot] = list(shared)
            if not self._ensure_blocks(slot, n_prompt):
                self._release_blocks(slot)
                return False
            if n_cached > 0 or self.prefill_chunk is not None:
                tr = _trace.default_tracer()
                if tr.enabled:
                    tr.async_begin("prefill", handle.trace.trace_id,
                                   cat="generation",
                                   args={"chunked": True,
                                         "prefix_cached": n_cached})
                self._chunking[slot] = _ChunkState(
                    request, handle, n_cached, time.perf_counter())
                self._chunk_step(slot)
                return True
        tok0, lp0 = self._flash_prefill(slot, request,
                                        handle.trace.trace_id)
        self._activate(slot, request, handle, tok0, lp0, sp.seed)
        return True

    def _flash_prefill(self, slot, request, trace_id):
        """The whole-prompt prefill of ``request`` into ``slot``: one
        causal forward over the bucket-padded prompt on the flash kernel,
        every layer's K/V written into the slot's cache rows, token 0
        sampled from the last real position.  Returns ``(tok0, lp0)``."""
        sp = request.sampling
        n_prompt = len(request.prompt_ids)
        bucket = self._bucket_for(n_prompt)
        dev = self.device
        tokens = torch.zeros((1, bucket), dtype=torch.long)
        tokens[0, :n_prompt] = torch.tensor(request.prompt_ids)
        tokens = tokens.to(dev)
        pos = torch.arange(bucket, device=dev)[None]
        t0 = time.perf_counter()
        tr = _trace.default_tracer()
        if tr.enabled:
            tr.async_begin("prefill", trace_id, cat="generation",
                           args={"bucket": bucket, "engine": self._engine})
        with _trace.span("generation.prefill", cat="generation",
                         args={"bucket": bucket, "slot": int(slot),
                               "request_id": request.request_id},
                         trace_id=trace_id), \
                torch.inference_mode():
            self._sigs["prefill"][bucket].add(_signature(tokens, pos))
            logits, kvs = self.model(tokens, pos, use_cache=True)
            arrays = self.cache.arrays()
            k_store, v_store = arrays[:2]
            if self.paged:
                # position p -> pool block table[p // bs], row p % bs;
                # padded positions past the allocated blocks hit table
                # entry 0 — the reserved garbage block
                p = np.arange(bucket)
                bs = self.block_size
                logical = np.clip(p // bs, 0, self.cache.max_blocks_per_slot
                                  - 1)
                bi = torch.from_numpy(
                    self.cache.table_row(slot)[logical].astype(np.int64)
                ).to(dev)
                off = torch.from_numpy(p % bs).to(dev)
                for li, (k, v) in enumerate(kvs):
                    if self.cache.quantized:
                        k_sc, v_sc = arrays[2:]
                        k_store[li, bi, off], k_sc[li, bi, off] = \
                            quantize_kv(k[0])
                        v_store[li, bi, off], v_sc[li, bi, off] = \
                            quantize_kv(v[0])
                    else:
                        k_store[li, bi, off] = k[0].to(k_store.dtype)
                        v_store[li, bi, off] = v[0].to(v_store.dtype)
            else:
                for li, (k, v) in enumerate(kvs):
                    k_store[li, slot, :bucket] = k[0].to(k_store.dtype)
                    v_store[li, slot, :bucket] = v[0].to(v_store.dtype)
            tok0, lp0 = self._sample_first(
                logits[0, n_prompt - 1:n_prompt], sp)
        self._m_prefill_ms.observe((time.perf_counter() - t0) * 1e3)
        if tr.enabled:
            tr.async_end("prefill", trace_id, cat="generation")
        return tok0, lp0

    def _sample_first(self, last, sp):
        """Generated token 0 from the last real row's logits ``last``
        [1, V] (step 0 of the request's stream), and its logprob when the
        engine reports them."""
        tok = sample_tokens(last, [sp.seed], [0], [sp.temperature],
                            [sp.top_k], [sp.top_p])
        lp = (float(token_logprobs(last, tok)[0]) if self.return_logprobs
              else None)
        return int(tok[0]), lp

    def _chunk_step(self, slot):
        """Advance one chunked prefill by one chunk: one model call that
        writes up to ``width`` prompt tokens' K/V at ``pos ..`` through
        the slot's table row and attends each row over the positions up
        to its own.  The width is ``prefill_chunk`` when set, else the
        whole remaining suffix bucketed to the prefill ladder (the
        prefix-hit path).  Padded rows' positions are clamped to the
        model's last position id (their outputs are ignored); their cache
        rows land past the prompt or in the garbage block."""
        cs = self._chunking[slot]
        request, handle = cs.request, cs.handle
        sp = request.sampling
        n_prompt = len(request.prompt_ids)
        remaining = n_prompt - cs.pos
        width = (self.prefill_chunk if self.prefill_chunk is not None
                 else self._bucket_for(remaining))
        c_real = min(width, remaining)
        if not self._grow_or_preempt(slot, cs.pos + c_real):
            self._chunking[slot] = None
            self._release_blocks(slot)
            self._free.append(slot)
            handle._fail("kv pool exhausted mid-prefill for request %s"
                         % request.request_id)
            return
        dev = self.device
        tokens = torch.zeros((1, width), dtype=torch.long)
        tokens[0, :c_real] = torch.tensor(
            request.prompt_ids[cs.pos:cs.pos + c_real])
        positions = (cs.pos + torch.arange(width)).clamp(
            max=self.cfg.max_position_embeddings - 1)[None]
        table = torch.from_numpy(
            self.cache.table_row(slot)[None].astype(np.int32)).to(dev)
        last = cs.pos + c_real >= n_prompt
        with _trace.span("generation.prefill_chunk", cat="generation",
                         args={"width": width, "slot": int(slot),
                               "pos": cs.pos,
                               "request_id": request.request_id}), \
                torch.inference_mode():
            tokens, positions = tokens.to(dev), positions.to(dev)
            start = torch.tensor([cs.pos], dtype=torch.int32, device=dev)
            self._sigs["chunk"].setdefault(width, set()).add(
                _signature(tokens, positions, start, table))
            logits, _ = self.model(
                tokens, positions, caches=self.cache.arrays(),
                cache_positions=start, block_tables=table,
                block_size=self.block_size)
            if last:
                tok0, lp0 = self._sample_first(
                    logits[0, c_real - 1:c_real], sp)
        cs.pos += c_real
        if last:
            self._chunking[slot] = None
            self._m_prefill_ms.observe((time.perf_counter() - cs.t0) * 1e3)
            tr = _trace.default_tracer()
            if tr.enabled:
                tr.async_end("prefill", handle.trace.trace_id,
                             cat="generation")
            self._activate(slot, request, handle, tok0, lp0,
                           sp.seed)

    def _activate(self, slot, request, handle, tok0, lp0, seed):
        """Prompt in cache: publish its full blocks to the prefix cache,
        prefill the draft model, arm the slot's decode state (``seed``
        names the request's random stream), emit token 0."""
        sp = request.sampling
        if self._prefix is not None:
            self._prefix.register(request.prompt_ids,
                                  self._slot_blocks[slot])
        if self.draft_model is not None:
            self._draft_prefill(slot, request)
        st = _Slot(request, handle)
        self._slot_state[slot] = st
        self._lengths[slot] = len(request.prompt_ids)
        self._last_tokens[slot] = tok0
        self._steps[slot] = 1
        self._seeds[slot] = seed
        self._temp[slot] = sp.temperature
        self._top_k[slot] = sp.top_k
        self._top_p[slot] = sp.top_p
        self._active[slot] = True
        self._emit(slot, st, tok0, lp0)
        self._m_ttft.observe((time.perf_counter() - handle.t_submit) * 1e3)

    # -- decode ------------------------------------------------------------
    def _decode_once(self):
        if self._step_hook is not None:
            try:
                self._step_hook(self._decode_steps)
            except EngineDeadError:
                self._die("injected death at decode step %d"
                          % self._decode_steps)
                raise
        if self.draft_model is not None and self._spec_viable():
            self._spec_once()
            return
        # plain step: make room for ONE new row per active slot
        if self.paged:
            for slot in list(np.nonzero(self._active)[0]):
                if not self._active[slot]:
                    continue           # preempted as an earlier victim
                if not self._grow_or_preempt(
                        slot, int(self._lengths[slot]) + 1):
                    self._fail_slot(
                        slot, "kv pool exhausted: no preemptable slot "
                        "left to make room")
            if not self._active.any():
                return
        t0 = time.perf_counter()
        dev = self.device
        with torch.inference_mode():
            lengths = torch.from_numpy(self._lengths).to(dev)
            tokens = torch.from_numpy(self._last_tokens).to(dev)[:, None]
            positions = lengths.long()[:, None]
            kw, inputs = {}, (tokens, positions, lengths)
            if self.paged:
                tables = torch.from_numpy(self._decode_tables()).to(dev)
                kw = {"block_tables": tables, "block_size": self.block_size}
                inputs += (tables,)
            if not self._sigs["decode_step"]:
                # fixed when the engine is built: learn it once
                self._sigs["decode_step"].add(_signature(*inputs))
            logits, _ = self.model(tokens, positions,
                                   caches=self.cache.arrays(),
                                   cache_positions=lengths, **kw)
            nxt = sample_tokens(logits[:, 0], self._seeds, self._steps,
                                self._temp, self._top_k, self._top_p)
            lps = (token_logprobs(logits[:, 0], nxt).cpu().numpy()
                   if self.return_logprobs else None)
            nxt = nxt.cpu().numpy()
        self._decode_steps += 1
        dt_ms = (time.perf_counter() - t0) * 1e3
        # the step put every ACTIVE slot's new token at lengths; advance
        # those counters (inactive rows computed garbage nobody reads)
        for slot in np.nonzero(self._active)[0]:
            self._lengths[slot] += 1
            self._steps[slot] += 1
            st = self._slot_state[slot]
            tok = int(nxt[slot])
            self._last_tokens[slot] = tok
            self._emit(slot, st, tok,
                       float(lps[slot]) if lps is not None else None)
            self._m_itl.observe(dt_ms)

    # -- speculative decoding ----------------------------------------------
    def _draft_prefill(self, slot, request):
        """Write the prompt's K/V into the draft's dense cache: one
        bucket-padded causal forward of the draft (the flash kernel on
        the card) fills rows ``0 .. bucket - 1`` of the slot.  No
        sampling: the draft only proposes from decode."""
        n_prompt = len(request.prompt_ids)
        bucket = self._bucket_for(n_prompt)
        dev = self.device
        tokens = torch.zeros((1, bucket), dtype=torch.long)
        tokens[0, :n_prompt] = torch.tensor(request.prompt_ids)
        kd, vd = self._draft_cache.arrays()
        with torch.inference_mode():
            tokens = tokens.to(dev)
            pos = torch.arange(bucket, device=dev)[None]
            self._sigs["draft_prefill"][bucket].add(_signature(tokens, pos))
            _, kvs = self.draft_model(tokens, pos, use_cache=True)
            for li, (k, v) in enumerate(kvs):
                kd[li, slot, :bucket] = k[0].to(kd.dtype)
                vd[li, slot, :bucket] = v[0].to(vd.dtype)

    def _draft_decode(self, positions, tokens):
        """One greedy draft decode step over ALL slots through the dense
        draft cache (the dense decode kernel on the card): ``tokens``
        [N] at ``positions`` [N]; returns the argmax tokens [N] (host)."""
        dev = self.device
        with torch.inference_mode():
            pos = torch.from_numpy(positions.astype(np.int32)).to(dev)
            tok = torch.from_numpy(tokens).to(dev)[:, None]
            if not self._sigs["draft_decode"]:
                # all slots, one row: fixed when the engine is built
                self._sigs["draft_decode"].add(_signature(tok, pos))
            logits, _ = self.draft_model(
                tok, pos.long()[:, None], caches=self._draft_cache.arrays(),
                cache_positions=pos)
            return logits[:, 0].argmax(dim=-1).cpu().numpy()

    def _draft_propose(self):
        """The draft's k greedy proposals [N, k] (host): k + 1 decode
        steps over all slots, step i feeding the token at position L + i
        and writing its row.  The last step only writes d_k's row, so
        that after a verify that accepts all k the next proposals see a
        whole draft cache (the reference takes k steps and leaves that
        row unwritten; ROADMAP Queue C).  An inactive slot's stale
        length may pass ``max_len - 1 - i``: its ignored rows stay inside
        the dense draft cache."""
        k = self.draft_len
        drafts = np.zeros((self.slots, k), np.int64)
        cur = self._last_tokens
        for i in range(k + 1):
            nxt = self._draft_decode(
                np.minimum(self._lengths + i, self.max_len - 1), cur)
            if i < k:
                drafts[:, i] = cur = nxt
        return drafts

    def _verify(self, tok_in):
        """Speculative verify: ``tok_in`` [N, k + 1] holds ``[last, d_1
        .. d_k]`` a slot, fed at positions ``L .. L + k`` in ONE model
        call over the paged cache (the chunk path, C = k + 1).  Row i is
        sampled with the slot's seed at ``steps + i``, so accepted tokens
        use exactly the random streams plain decode would have.  Returns
        the host tokens [N, k + 1] and, on a logprob engine, their
        logprobs (else None)."""
        s_len = self.draft_len + 1
        dev = self.device
        with torch.inference_mode():
            lengths = torch.from_numpy(self._lengths).to(dev)
            # an inactive slot's stale length may sit within k of
            # max_len: clamp its (ignored) rows' position ids into the
            # table (active slots keep L + k < max_len, `_spec_viable`)
            positions = (lengths.long()[:, None]
                         + torch.arange(s_len, device=dev)[None]).clamp(
                max=self.cfg.max_position_embeddings - 1)
            tok = torch.from_numpy(tok_in).to(dev)
            tables = torch.from_numpy(self._decode_tables()).to(dev)
            if not self._sigs["verify"]:
                # all slots, k + 1 rows: fixed when the engine is built
                self._sigs["verify"].add(_signature(tok, positions,
                                                    lengths, tables))
            logits, _ = self.model(
                tok, positions, caches=self.cache.arrays(),
                cache_positions=lengths, block_tables=tables,
                block_size=self.block_size)
            toks = torch.stack(
                [sample_tokens(logits[:, i], self._seeds, self._steps + i,
                               self._temp, self._top_k, self._top_p)
                 for i in range(s_len)], dim=1)                # [N, S]
            lps = None
            if self.return_logprobs:
                lps = torch.stack([token_logprobs(logits[:, i], toks[:, i])
                                   for i in range(s_len)],
                                  dim=1).cpu().numpy()
            return toks.cpu().numpy(), lps

    def _spec_viable(self):
        """A verify step writes draft_len + 1 rows a slot: every active
        slot needs that much max_len headroom, and the pool must cover
        it (otherwise this iteration takes a plain step, which needs one
        row)."""
        active = np.nonzero(self._active)[0]
        if len(active) == 0:
            return False
        s_len = self.draft_len + 1
        if not (self._lengths[active] + s_len <= self.max_len).all():
            return False
        for slot in active:
            if not self._ensure_blocks(slot,
                                       int(self._lengths[slot]) + s_len):
                return False
        return True

    def _spec_once(self):
        """Draft k greedy proposals (`_draft_propose`), ONE batched
        verify, host-side acceptance: a greedy slot emits the longest
        draft prefix the target agrees with plus the correction token; a
        sampled slot emits exactly its row-0 sample (its random stream
        untouched).
        Cache rows of rejected drafts are garbage past the new length
        that later writes overwrite."""
        k = self.draft_len
        t0 = time.perf_counter()
        drafts = self._draft_propose()
        tok_in = np.concatenate([self._last_tokens[:, None], drafts], axis=1)
        toks, lps = self._verify(tok_in)
        self._decode_steps += 1
        dt_ms = (time.perf_counter() - t0) * 1e3
        for slot in np.nonzero(self._active)[0]:
            j = 0
            if self._temp[slot] <= 0.0:
                while j < k and drafts[slot, j] == toks[slot, j]:
                    j += 1
                self._m_spec_proposed.inc(k)
                self._m_spec_accepted.inc(j)
            st = self._slot_state[slot]
            for i in range(j + 1):
                self._lengths[slot] += 1
                self._steps[slot] += 1
                tok = int(toks[slot, i])
                self._last_tokens[slot] = tok
                self._emit(slot, st, tok,
                           float(lps[slot, i]) if lps is not None else None)
                if not self._active[slot]:
                    break              # stop token / limits mid-accept
            self._m_itl.observe(dt_ms)

    # -- token delivery ----------------------------------------------------
    def _emit(self, slot, st, token, logprob=None):
        """Deliver one generated token and apply stop conditions."""
        st.handle._emit(st.generated, token, logprob)
        st.generated += 1
        self._m_tokens.inc()
        reason = None
        if token in st.request.stop_token_ids:
            reason = "stop_token"
        elif st.generated >= st.request.max_new_tokens:
            reason = "max_new_tokens"
        elif self._lengths[slot] + 1 >= self.max_len:
            reason = "cache_full"
        if reason is not None:
            self._finish_slot(slot, reason)

    def _finish_slot(self, slot, reason):
        st = self._slot_state[slot]
        st.handle._finish(reason)
        self._slot_state[slot] = None
        self._active[slot] = False
        if self.paged:
            self._release_blocks(slot)
        self._free.append(slot)
        _trace.instant("generation.finish", cat="generation",
                       args={"slot": int(slot), "reason": reason,
                             "request_id": st.request.request_id})

    # -- death -------------------------------------------------------------
    def _die(self, why):
        self._dead = True
        affected = []
        for slot, st in enumerate(self._slot_state):
            if st is not None:
                affected.append(st.handle)
                self._slot_state[slot] = None
            if self._chunking[slot] is not None:
                affected.append(self._chunking[slot].handle)
                self._chunking[slot] = None
            if self.paged and self._slot_blocks[slot]:
                self._release_blocks(slot)
        self._active[:] = False
        affected.extend(h for _, h in self._pending)
        self._pending = []
        self._affected_on_death = affected
        _trace.instant("generation.engine_death", cat="generation",
                       args={"engine": self._engine, "why": why})
        tr = _trace.default_tracer()
        if tr.enabled:
            for h in affected:
                tr.async_instant("replica_death", h.trace.trace_id,
                                 cat="generation",
                                 args={"engine": self._engine, "why": why})
        if self.on_death is not None:
            self.on_death(self, affected)
        else:
            for h in affected:
                h._fail("engine %s died: %s" % (self._engine, why))

    def kill(self, why="killed"):
        """Operator or drill kill: the handles in flight, chunking or
        queued go to the ``on_death`` hook (the fleet requeues them), or
        fail when there is none."""
        with self._lock:
            if not self._dead:
                self._die(why)
            self._work.notify_all()

    @property
    def dead(self):
        return self._dead

    @property
    def affected_on_death(self):
        """Handles that were in flight or queued when the engine died."""
        return list(self._affected_on_death)

    # -- background loop ---------------------------------------------------
    def start(self):
        """Run the scheduler on a background thread (serving mode)."""
        if self._thread is not None:
            return self
        self._t0 = time.perf_counter()
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, name="genloop-%s" % self._engine,
            daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while True:
            with self._lock:
                if self._stop or self._dead:
                    return
                busy = (bool(self._pending) or bool(self._active.any())
                        or any(c is not None for c in self._chunking))
                if not busy:
                    self._work.wait(0.05)
                    continue
            try:
                self.step()
            except EngineDeadError:
                return
            except Exception as e:     # pragma: no cover - defensive
                with self._lock:
                    self._die("engine loop crashed: %s: %s"
                              % (type(e).__name__, e))
                return

    def stop(self):
        with self._lock:
            self._stop = True
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # -- disaggregated prefill / decode (tp_serving.disagg) ----------------
    def prefill_extract(self, request, trace=None):
        """The prefill half of a disaggregated pair: run ONE whole-prompt
        flash prefill for ``request`` in a free slot, lift the slot's
        pages (every array of the pool: K and V, and an int8 pool's
        scales) and token 0 off the engine, release the slot, and return
        the `tp_serving.KVHandoff` a decode engine takes with
        `inject_prefilled`.  Bypasses the scheduler (sheds with
        `ShedError` when no slot or no blocks are free) and never runs
        the decode step.  ``trace``: an optional `TraceContext` or its
        wire dict, which the handoff carries to the decode side."""
        from ..tp_serving.disagg import KVHandoff

        if not self.paged:
            raise ValueError("prefill_extract requires paged=True")
        if not isinstance(request, GenerationRequest):
            request = GenerationRequest(request)
        tc = _trace.TraceContext.from_wire(trace)
        tr = _trace.default_tracer()
        if tc is None:
            tc = _trace.TraceContext()
            if tr.enabled:
                # no upstream front began this request's track
                tr.async_begin("request", tc.trace_id, cat="generation",
                               args={"request_id": request.request_id})
        n_prompt = len(request.prompt_ids)
        with self._lock:
            if self._dead:
                raise EngineDeadError("engine %s is dead" % self._engine)
            if not self._free:
                raise ShedError(
                    "slots_full", self._retry_after_locked(),
                    "prefill engine %s has no free slot" % self._engine)
            slot = self._free.pop(0)
            self._slot_blocks[slot] = []
            if not self._ensure_blocks(slot, n_prompt):
                self._release_blocks(slot)
                self._free.insert(0, slot)
                raise ShedError(
                    "kv_pool_exhausted", self._retry_after_locked(),
                    "prefill engine %s pool dry" % self._engine)
            try:
                tok0, lp0 = self._flash_prefill(slot, request, tc.trace_id)
                # advanced indexing copies: the pages stay valid after
                # the blocks go back to the pool
                idx = torch.tensor(self._slot_blocks[slot],
                                   dtype=torch.long, device=self.device)
                pages = tuple(a[:, idx] for a in self.cache.arrays())
            finally:
                self._release_blocks(slot)
                self._free.append(slot)
        handoff = KVHandoff(
            request=request, n_prompt=n_prompt, tok0=tok0, lp0=lp0,
            key=request.sampling.seed, pages=pages,
            block_size=self.block_size, kv_dtype=self.cache.kv_dtype,
            trace=tc.child("prefill").to_wire())
        if tr.enabled:
            tr.async_begin("handoff", tc.trace_id, cat="generation",
                           args={"bytes": handoff.nbytes})
        return handoff

    def inject_prefilled(self, handoff, _handle=None):
        """The decode half: queue a `KVHandoff` for this engine.  The
        scheduler copies its pages into fresh blocks, arms the slot and
        emits token 0; the request decodes here without this engine ever
        running a prefill (`stats()["executables"]["prefill"]` stays 0).
        Queues and sheds as `submit` does; ``_handle`` re-attaches an
        existing handle."""
        if not self.paged:
            raise ValueError("inject_prefilled requires paged=True")
        if handoff.block_size != self.block_size:
            raise ValueError("handoff block_size %d != engine %d"
                             % (handoff.block_size, self.block_size))
        if handoff.kv_dtype != self.cache.kv_dtype:
            raise ValueError("handoff kv_dtype %r != engine %r"
                             % (handoff.kv_dtype, self.cache.kv_dtype))
        shape = self.cache.shape
        page = tuple(handoff.pages[0].shape)
        if page[0] != shape[0] or page[2:] != shape[2:]:
            raise ValueError("handoff page geometry %r does not fit pool %r"
                             % (page, shape))
        with self._lock:
            if self._dead:
                raise EngineDeadError("engine %s is dead" % self._engine)
            if len(self._pending) >= self.max_queue:
                err = ShedError(
                    "slots_full", self._retry_after_locked(),
                    "decode engine %s: all %d slots busy and %d requests "
                    "queued" % (self._engine, self.slots,
                                len(self._pending)))
                self._m_shed.labels(self._engine, err.reason).inc()
                self._record_request({
                    "request_id": handoff.request.request_id,
                    "trace_id": None, "t_wall": time.time(),
                    "outcome": "shed", "ttft_ms": None, "itl_ms": None,
                    "n_tokens": 0, "duration_ms": 0.0})
                raise err
            handle = _handle if _handle is not None else RequestHandle(
                handoff.request,
                trace=_trace.TraceContext.from_wire(handoff.trace))
            handle._sink = self._record_request
            tr = _trace.default_tracer()
            if tr.enabled:
                tid = handle.trace.trace_id
                tr.async_end("handoff", tid, cat="generation",
                             args={"engine": self._engine})
                tr.async_begin("queue", tid, cat="generation")
            self._pending.append((handoff, handle))
            self._m_requests.inc()
            self._m_queue.set(len(self._pending))
            self._work.notify_all()
        return handle

    def _inject_into(self, slot, handoff, handle):
        """Adopt a handoff's pages under the lock: fresh blocks, the
        table row rebuilt, every pool array's pages copied in, decode
        armed.  Returns False (the caller requeues) when the pool is
        dry."""
        n_blocks = int(handoff.pages[0].shape[1])
        self._slot_blocks[slot] = []
        if not self._ensure_blocks(slot, n_blocks * self.block_size):
            self._release_blocks(slot)
            return False
        idx = torch.tensor(self._slot_blocks[slot], dtype=torch.long,
                           device=self.device)
        with torch.inference_mode():
            for a, page in zip(self.cache.arrays(), handoff.pages):
                a[:, idx] = page.to(a.device)
        tr = _trace.default_tracer()
        if tr.enabled:
            tr.async_instant("inject", handle.trace.trace_id,
                             cat="generation",
                             args={"slot": int(slot), "blocks": n_blocks})
        self._activate(slot, handoff.request, handle, handoff.tok0,
                       handoff.lp0, handoff.key)
        return True

    # -- weight swap -------------------------------------------------------
    def snapshot_params(self):
        """CPU copies of the serving weights under the model's
        ``state_dict`` names: a rollback point for `swap_params`."""
        with self._lock:
            return {k: v.detach().to("cpu", copy=True)
                    for k, v in self.model.state_dict().items()}

    def swap_params(self, params):
        """Replace the serving weights between two steps.

        ``params`` maps every ``state_dict`` name of the model to a
        tensor (or array) of its exact shape and dtype; anything else
        raises `ValueError` before a weight moves, and a dead engine
        raises `EngineDeadError`.  In-flight requests see at most one
        token from the old weights, never a step that mixes the two.
        The first swap gives this engine its own copy of the model, its
        weights the new tensors, so the module it was built from (the
        caller's, shared with other engines) never changes; later swaps
        copy into that copy in place."""
        with self._lock:
            if self._dead:
                raise EngineDeadError("swap_params on dead engine %s"
                                      % self._engine)
            base = self.model
            cur = base.state_dict(keep_vars=True)
            owned = self._owns_model
        names = set(map(str, params.keys()))
        if names != set(cur):
            raise ValueError(
                "swap_params name mismatch: missing=%r extra=%r"
                % (sorted(set(cur) - names), sorted(names - set(cur))))
        new = {}
        for k, old in cur.items():
            t = torch.as_tensor(params[k])
            if tuple(t.shape) != tuple(old.shape) or t.dtype != old.dtype:
                raise ValueError(
                    "swap_params %r: got %s %s, engine serves %s %s"
                    % (k, tuple(t.shape), t.dtype, tuple(old.shape),
                       old.dtype))
            new[k] = t
        # stage on the device outside the lock (the steps go on), then
        # install between two steps
        new = {k: t.detach().to(self.device, copy=True)
               for k, t in new.items()}
        model = None
        if not owned:
            # the copy's tensors ARE the staged ones; everything else of
            # the module (its structure, its config) is deep-copied
            memo = {id(old): (torch.nn.Parameter(
                new[k], requires_grad=old.requires_grad)
                if isinstance(old, torch.nn.Parameter) else new[k])
                for k, old in cur.items()}
            model = copy.deepcopy(base, memo)
        with self._lock:
            if self._dead:
                raise EngineDeadError("swap_params on dead engine %s"
                                      % self._engine)
            if model is not None and self.model is base:
                self.model = model
                self._owns_model = True
            else:
                # owned, or another swap installed its own copy while
                # this one staged: the last swap to install wins
                with torch.no_grad():
                    for k, t in self.model.state_dict().items():
                        t.copy_(new[k])

    # -- introspection -----------------------------------------------------
    def _decode_cache_size(self):
        """Distinct launch signatures of the decode step (1 once it has
        run): the reference's compile-once pin, as the port counts it."""
        return len(self._sigs["decode_step"])

    def occupancy(self):
        with self._lock:
            return {
                "slots": self.slots,
                "active": int(self._active.sum()),
                "chunking": sum(c is not None for c in self._chunking),
                "free": len(self._free),
                "pending": len(self._pending),
            }

    def stats(self):
        occ = self.occupancy()
        occ.update({
            "engine": self._engine,
            "dead": self._dead,
            "device": str(self.device),
            "decode_steps": self._decode_steps,
            "max_len": self.max_len,
            "prefill_buckets": list(self.prefill_buckets),
            "cache": self.cache.describe(),
            "decode_executables": self._decode_cache_size(),
            "preempted": int(self._m_preempt.value),
        })
        occ["executables"] = {
            k: ({b: len(v) for b, v in t.items()} if isinstance(t, dict)
                else len(t)) for k, t in self._sigs.items()}
        if self._prefix is not None:
            occ["prefix_cache"] = self._prefix.stats()
        if self.draft_model is not None:
            proposed = int(self._m_spec_proposed.value)
            accepted = int(self._m_spec_accepted.value)
            occ["speculative"] = {
                "draft_len": self.draft_len,
                "proposed": proposed,
                "accepted": accepted,
                "acceptance_rate": (accepted / proposed) if proposed
                else 0.0,
            }
        return occ

    # -- convenience -------------------------------------------------------
    def generate(self, prompts, max_new_tokens=16, sampling=None,
                 stop_token_ids=(), timeout=120.0):
        """Synchronous batch helper: submit all, drive to idle, return
        token lists in prompt order."""
        handles = []
        for i, p in enumerate(prompts):
            sp = sampling[i] if isinstance(sampling, (list, tuple)) \
                else sampling
            handles.append(self.submit(GenerationRequest(
                p, max_new_tokens=max_new_tokens, sampling=sp,
                stop_token_ids=stop_token_ids)))
        if self._thread is None:
            self.run_until_idle()
        return [h.result(timeout=timeout) for h in handles]


def sequential_oracle(make_engine, requests, timeout=120.0):
    """The exactness reference: a FRESH engine per request, one request
    at a time — no continuous batching, no slot reuse, no shared state.
    Returns the per-request token lists.  `make_engine()` must build an
    engine with the same (slots, max_len, buckets) config as the engine
    under test."""
    out = []
    for r in requests:
        eng = make_engine()
        h = eng.submit(GenerationRequest(
            r.prompt_ids, max_new_tokens=r.max_new_tokens,
            sampling=r.sampling, stop_token_ids=r.stop_token_ids,
            request_id=r.request_id + ":oracle"))
        eng.run_until_idle()
        out.append(h.result(timeout=timeout))
    return out

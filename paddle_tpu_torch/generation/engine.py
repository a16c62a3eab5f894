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
  preempts the least-progressed slot (restart semantics) rather than
  crashing.  ``paged=False`` keeps the dense layout as the A/B
  baseline, decoding through the dense kernel.

Exactness: scheduling is invisible in the tokens.  Per-request random
streams (`sampling.py`) and row-independent slot math make the output
token-for-token identical to serving the same requests one at a time
(`sequential_oracle`); paged and dense engines prefill through the same
forward and decode through kernels that are bitwise equal on the card.

Not ported yet (the constructor raises `NotImplementedError` for each):
prefix caching, chunked prefill, int8 KV, speculative decoding and
logprobs; nor the disaggregated ``prefill_extract`` /
``inject_prefilled`` pair and ``swap_params``.  The device cache is
updated in place, so ``donate`` has nothing to select and is accepted
for signature parity only.
"""

from __future__ import annotations

import itertools
import math
import queue
import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from ..observability import locks as _locks
from ..observability import trace as _trace
from ..observability.metrics import default_registry, unique_instance_label
from .kv_cache import KVCache, PagedKVCache, PoolExhausted
from .sampling import SamplingParams, sample_tokens

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
    `retry_after_s` is the integer seconds for the Retry-After header
    (`paddle_tpu.serving.admission.ShedError`)."""

    def __init__(self, reason, retry_after_s=1, detail=""):
        self.reason = reason
        self.retry_after_s = max(1, int(math.ceil(retry_after_s)))
        super().__init__(
            "request shed (%s)%s; retry after %ds"
            % (reason, (": " + detail) if detail else "", self.retry_after_s))


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
    plus terminal events.  ``restart`` events (preemption on pool
    exhaustion re-runs the request from scratch) reset the index stream
    to 0; a consumer discards what it saw before."""

    def __init__(self, request, trace=None):
        self.request = request
        self._q = queue.Queue()
        self._done = threading.Event()
        self._tokens = []
        self.finish_reason = None
        self.error = None
        self.t_submit = time.perf_counter()
        self.t_first_token = None
        self.t_tokens = []             # host clock at each token's delivery
        self.trace = trace if trace is not None else _trace.TraceContext()
        self._sink = None              # engine's per-request record sink

    # -- engine side ------------------------------------------------------
    def _emit(self, index, token):
        now = time.perf_counter()
        if index == 0:
            self.t_first_token = now
        self._tokens.append(int(token))
        self.t_tokens.append(now)
        tr = _trace.default_tracer()
        if tr.enabled:
            tr.async_instant("token", self.trace.trace_id,
                             cat="generation", args={"index": index})
        self._q.put(("token", index, int(token)))

    def _restart(self):
        self._tokens = []
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

    @property
    def done(self):
        return self._done.is_set()


class _Slot:
    __slots__ = ("request", "handle", "generated")

    def __init__(self, request, handle):
        self.request = request
        self.handle = handle
        self.generated = 0


class GenerationEngine:
    """See module docstring.

    ``model`` is a `models.TransformerLM` (or anything with its forward
    contract and a ``cfg``); the engine moves it to ``device`` (default:
    the card; raises when there is none) and into eval mode.
    ``slots`` x ``max_len`` sizes the cache; ``prefill_buckets`` is the
    prompt-length ladder (default: pow2).  ``max_queue`` bounds the
    pending queue — beyond it `submit` sheds (`ShedError`).
    ``step_hook(step_no)`` runs before every decode step.

    Paged knobs: ``paged`` (default True) selects the block pool;
    ``block_size`` is its row granularity; ``kv_blocks`` sizes it
    (default: dense parity — ``slots * ceil(max_len / block_size) + 1``;
    provision below that and preemption absorbs the tail)."""

    def __init__(self, model, *, slots=4, max_len=256,
                 prefill_buckets=None, max_queue=64, name="gen",
                 metrics_registry=None, step_hook=None, donate=None,
                 logprobs=False, paged=True, block_size=16,
                 kv_blocks=None, prefix_cache=False, prefill_chunk=None,
                 kv_dtype=None, draft_model=None, draft_len=0,
                 request_sink=None, device=None):
        for unported, knob in ((logprobs, "logprobs=True"),
                               (prefix_cache, "prefix_cache"),
                               (prefill_chunk, "prefill_chunk"),
                               (kv_dtype is not None, "kv_dtype"),
                               (draft_model is not None, "draft_model")):
            if unported:
                raise NotImplementedError(
                    "GenerationEngine(%s): not ported to paddle_tpu_torch "
                    "yet" % knob)
        cfg = model.cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
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
                device=self.device)
            self._slot_blocks = [[] for _ in range(n)]
        else:
            self.block_size = None
            self.cache = KVCache(cfg.num_layers, n, self.max_len,
                                 cfg.num_heads, cfg.head_dim, dtype=dtype,
                                 device=self.device)
            self._slot_blocks = None
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
        self._t0 = time.perf_counter()
        self._request_sink = request_sink

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

    # -- block accounting (paged) -----------------------------------------
    def _set_block_gauges(self):
        self._m_blocks_used.set(self.cache.pool.used_blocks)
        self._m_blocks_free.set(self.cache.pool.free_blocks)

    def _ensure_blocks(self, slot, n_tokens):
        """Grow the slot's table to cover ``n_tokens`` cache rows; False
        when the pool is dry (the caller preempts/sheds)."""
        need = self.cache.blocks_for(n_tokens) - len(self._slot_blocks[slot])
        if need <= 0:
            return True
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
        """Return every block the slot holds and point its table row
        back at the garbage block."""
        ids = self._slot_blocks[slot]
        if ids:
            self.cache.pool.decref(ids)
            self._slot_blocks[slot] = []
        self.cache.clear_slot(slot)
        self._set_block_gauges()

    def _preempt_slot(self, slot, why):
        """Pool-pressure eviction of a running request: every block
        returns to the pool and the request restarts from the front of
        the queue (the handle's stream resets)."""
        st = self._slot_state[slot]
        self._slot_state[slot] = None
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
        progressed OTHER slot (fewest generated tokens, lowest id) until
        it fits; False when no victim is left."""
        while not self._ensure_blocks(slot, n_tokens):
            victims = [s for s in range(self.slots)
                       if s != slot and self._slot_state[s] is not None]
            if not victims:
                return False
            self._preempt_slot(
                min(victims, key=lambda s: (self._slot_state[s].generated,
                                            s)),
                "pool_exhausted")
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
        reserved garbage block."""
        return np.where(self._active[:, None], self.cache.block_tables,
                        0).astype(np.int32)

    # -- admission / submission -------------------------------------------
    def submit(self, request, _handle=None):
        """Queue a request; returns its `RequestHandle`.  Sheds
        (`ShedError`, reason ``slots_full``) when the pending queue is
        at ``max_queue``; refuses requests that can never fit."""
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
        backlog = sum(r.max_new_tokens for r, _ in self._pending) or 1
        return max(1.0, backlog / rate)

    def _record_request(self, rec):
        """Sink for per-request SLO records: stamp the engine and forward
        to ``request_sink``.  Never raises into the serving path."""
        rec = dict(rec, engine=self._engine)
        sink = self._request_sink
        if sink is not None:
            try:
                sink(rec)
            except Exception:
                pass

    # -- scheduler ---------------------------------------------------------
    def step(self):
        """One scheduler iteration: refill free slots (prefill), then one
        decode step over the active batch.  Returns True when any work
        happened."""
        with self._lock:
            if self._dead:
                raise EngineDeadError("engine %s is dead" % self._engine)
            progressed = False
            while self._free and self._pending:
                request, handle = self._pending.pop(0)
                slot = self._free.pop(0)
                self._m_queue.set(len(self._pending))
                tr = _trace.default_tracer()
                if tr.enabled:
                    tr.async_end("queue", handle.trace.trace_id,
                                 cat="generation")
                if not self._prefill_into(slot, request, handle):
                    # pool dry at admission: requeue and wait for a
                    # running request to free blocks — unless nothing
                    # is running, in which case it never will
                    self._free.insert(0, slot)
                    if self._active.any():
                        self._pending.insert(0, (request, handle))
                        self._m_queue.set(len(self._pending))
                        if tr.enabled:
                            tr.async_begin("queue", handle.trace.trace_id,
                                           cat="generation")
                    else:
                        handle._fail(
                            "kv pool exhausted: request %s needs more "
                            "blocks than the pool can ever free"
                            % request.request_id)
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
        """Claim blocks (paged) and run the whole-prompt prefill: one
        causal forward over the bucket-padded prompt, every layer's K/V
        written into the slot's cache rows, token 0 sampled from the
        last real position.  Returns False (nothing claimed) when the
        pool is dry."""
        sp = request.sampling
        n_prompt = len(request.prompt_ids)
        if self.paged:
            self._slot_blocks[slot] = []
            if not self._ensure_blocks(slot, n_prompt):
                self._release_blocks(slot)
                return False
        bucket = self._bucket_for(n_prompt)
        dev = self.device
        tokens = torch.zeros((1, bucket), dtype=torch.long)
        tokens[0, :n_prompt] = torch.tensor(request.prompt_ids)
        pos = torch.arange(bucket, device=dev)[None]
        t0 = time.perf_counter()
        tr = _trace.default_tracer()
        if tr.enabled:
            tr.async_begin("prefill", handle.trace.trace_id,
                           cat="generation", args={"bucket": bucket})
        with _trace.span("generation.prefill", cat="generation",
                         args={"bucket": bucket, "slot": int(slot),
                               "request_id": request.request_id},
                         trace_id=handle.trace.trace_id), \
                torch.inference_mode():
            logits, kvs = self.model(tokens.to(dev), pos, use_cache=True)
            k_store, v_store = self.cache.arrays()
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
                    k_store[li, bi, off] = k[0].to(k_store.dtype)
                    v_store[li, bi, off] = v[0].to(v_store.dtype)
            else:
                for li, (k, v) in enumerate(kvs):
                    k_store[li, slot, :bucket] = k[0].to(k_store.dtype)
                    v_store[li, slot, :bucket] = v[0].to(v_store.dtype)
            last = logits[0, n_prompt - 1:n_prompt]           # [1, V]
            tok0 = int(sample_tokens(last, [sp.seed], [0], [sp.temperature],
                                     [sp.top_k], [sp.top_p])[0])
        self._m_prefill_ms.observe((time.perf_counter() - t0) * 1e3)
        if tr.enabled:
            tr.async_end("prefill", handle.trace.trace_id, cat="generation")
        self._activate(slot, request, handle, tok0)
        return True

    def _activate(self, slot, request, handle, tok0):
        """Prompt in cache: arm the slot's decode state, emit token 0."""
        sp = request.sampling
        st = _Slot(request, handle)
        self._slot_state[slot] = st
        self._lengths[slot] = len(request.prompt_ids)
        self._last_tokens[slot] = tok0
        self._steps[slot] = 1
        self._seeds[slot] = sp.seed
        self._temp[slot] = sp.temperature
        self._top_k[slot] = sp.top_k
        self._top_p[slot] = sp.top_p
        self._active[slot] = True
        self._emit(slot, st, tok0)
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
        # make room for ONE new row per active slot
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
            kw = {}
            if self.paged:
                kw = {"block_tables": torch.from_numpy(
                          self._decode_tables()).to(dev),
                      "block_size": self.block_size}
            logits, _ = self.model(tokens, lengths.long()[:, None],
                                   caches=self.cache.arrays(),
                                   cache_positions=lengths, **kw)
            nxt = sample_tokens(logits[:, 0], self._seeds, self._steps,
                                self._temp, self._top_k,
                                self._top_p).cpu().numpy()
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
            self._emit(slot, st, tok)
            self._m_itl.observe(dt_ms)

    # -- token delivery ----------------------------------------------------
    def _emit(self, slot, st, token):
        """Deliver one generated token and apply stop conditions."""
        st.handle._emit(st.generated, token)
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
            if self.paged and self._slot_blocks[slot]:
                self._release_blocks(slot)
        self._active[:] = False
        affected.extend(h for _, h in self._pending)
        self._pending = []
        _trace.instant("generation.engine_death", cat="generation",
                       args={"engine": self._engine, "why": why})
        for h in affected:
            h._fail("engine %s died: %s" % (self._engine, why))

    def kill(self, why="killed"):
        """Operator kill: in-flight and queued handles fail."""
        with self._lock:
            if not self._dead:
                self._die(why)
            self._work.notify_all()

    @property
    def dead(self):
        return self._dead

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
                if not (self._pending or self._active.any()):
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

    # -- introspection -----------------------------------------------------
    def occupancy(self):
        with self._lock:
            return {
                "slots": self.slots,
                "active": int(self._active.sum()),
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
            "preempted": int(self._m_preempt.value),
        })
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

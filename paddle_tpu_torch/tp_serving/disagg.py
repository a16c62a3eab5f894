"""Disaggregated prefill / decode serving (the DistServe split).

Counterpart of `paddle_tpu.tp_serving.disagg`.  Prefill engines run only
prefills and hand each finished prompt's KV — the slot's paged blocks
and enough to rebuild its block-table row — to decode engines, which run
only the decode step.  The two phases stop competing for one engine:
prefill's long compute-bound calls no longer stall decode's
latency-bound steps.

* `KVHandoff` — the unit handed over: the pool pages ``[L, n_blocks,
  bs, H, Dh]`` of every pool array (an int8 pool's scales too), the
  first sampled token, the request's sampling seed (the reference's
  PRNG key: the decode engine draws step >= 1 from it as a single
  engine would) and the geometry checked on arrival.  On one card the
  pages stay device tensors; ``nbytes`` is what a deployment would
  move between cards, which `DisaggPair` and `ShardGroupFleet` meter as
  ``kv_transfer_bytes``.
* `DisaggPair` — a prefill-role and a decode-role engine; ``submit``
  runs `prefill_extract` then `inject_prefilled`, and the decode
  engine's scheduler does the rest.
* `ShardGroupFleet` — the group-level router: a request goes to the
  group with the most decode headroom (free slots minus queued work),
  ties to the lowest group id.

The role pin: a decode engine never runs a prefill, so its
``stats()["executables"]["prefill"]`` entries stay 0.
"""

from __future__ import annotations

from ..generation.engine import GenerationRequest
from ..observability import locks as _locks
from ..observability.metrics import default_registry, unique_instance_label

__all__ = [
    "DisaggPair",
    "KVHandoff",
    "ShardGroupFleet",
    "extract_prefilled",
    "inject_prefilled",
]


class KVHandoff:
    """One prefilled request's KV, on its way between engines.

    ``trace`` is the request's `observability.trace.TraceContext` wire
    dict (or None): the decode engine's spans land on the same trace id
    as the prefill engine's."""

    __slots__ = ("request", "n_prompt", "tok0", "lp0", "key", "pages",
                 "block_size", "kv_dtype", "trace")

    def __init__(self, request, n_prompt, tok0, lp0, key, pages,
                 block_size, kv_dtype, trace=None):
        self.request = request
        self.n_prompt = int(n_prompt)
        self.tok0 = int(tok0)
        self.lp0 = lp0
        self.key = key
        self.pages = tuple(pages)
        self.block_size = int(block_size)
        self.kv_dtype = kv_dtype
        self.trace = trace

    @property
    def nbytes(self):
        """Bytes a deployment would move for this handoff."""
        return int(sum(p.numel() * p.element_size() for p in self.pages))

    def describe(self):
        return {
            "request_id": self.request.request_id,
            "n_prompt": self.n_prompt,
            "blocks": int(self.pages[0].shape[1]),
            "bytes": self.nbytes,
            "kv_dtype": self.kv_dtype or "float32",
        }


def extract_prefilled(engine, request):
    """Functional alias for ``engine.prefill_extract(request)``."""
    return engine.prefill_extract(request)


def inject_prefilled(engine, handoff, _handle=None):
    """Functional alias for ``engine.inject_prefilled(handoff)``."""
    return engine.inject_prefilled(handoff, _handle=_handle)


class DisaggPair:
    """One group: a prefill-role engine and a decode-role engine.

    Handoff, transfer and occupancy telemetry lives in the metrics
    registry as ``disagg_*`` families under a unique ``group`` label;
    `stats()` reads the same series back."""

    def __init__(self, prefill_engine, decode_engine, group_id=0,
                 metrics_registry=None):
        if not prefill_engine.paged or not decode_engine.paged:
            raise ValueError("disaggregation requires paged engines")
        if prefill_engine.block_size != decode_engine.block_size:
            raise ValueError(
                "block_size mismatch: prefill %d, decode %d"
                % (prefill_engine.block_size, decode_engine.block_size))
        self.prefill = prefill_engine
        self.decode = decode_engine
        self.group_id = int(group_id)
        self._lock = _locks.named_lock("tp_serving.disagg.group")
        reg = metrics_registry or default_registry()
        self.metrics_registry = reg
        self._group_label = unique_instance_label("group%d" % self.group_id)
        lbl = ("group",)
        self._m_handoffs = reg.counter(
            "disagg_handoffs_total", "KV handoffs prefill -> decode",
            labelnames=lbl).labels(self._group_label)
        self._m_kv_bytes = reg.counter(
            "disagg_kv_transfer_bytes_total",
            "Bytes of KV pages moved prefill -> decode",
            labelnames=lbl).labels(self._group_label)
        reg.gauge(
            "disagg_headroom", "Free decode slots minus queued work",
            labelnames=lbl).labels(self._group_label).set_function(
                self.headroom)
        reg.gauge(
            "disagg_queue_depth", "Queued handoffs on the decode engine",
            labelnames=lbl).labels(self._group_label).set_function(
                lambda: len(self.decode._pending))
        reg.gauge(
            "disagg_free_decode_slots", "Free decode slots",
            labelnames=lbl).labels(self._group_label).set_function(
                self.free_decode_slots)

    @property
    def handoffs(self):
        return int(self._m_handoffs.value)

    @property
    def kv_transfer_bytes(self):
        return int(self._m_kv_bytes.value)

    def free_decode_slots(self):
        return len(self.decode._free)

    def headroom(self):
        """Free decode slots minus queued work — the routing signal
        (queued handoffs have not taken a slot yet but will)."""
        return len(self.decode._free) - len(self.decode._pending)

    def submit(self, request, _handle=None, trace=None):
        """Prefill on the prefill engine, hand the KV over, decode on the
        decode engine.  Returns the decode-side handle.  ``trace`` (a
        `TraceContext` or its wire dict) pins the request's timeline id;
        without one the prefill engine mints a context that the handoff
        carries to the decode side."""
        if not isinstance(request, GenerationRequest):
            request = GenerationRequest(request)
        handoff = self.prefill.prefill_extract(request, trace=trace)
        with self._lock:
            self._m_kv_bytes.inc(handoff.nbytes)
            self._m_handoffs.inc()
        return self.decode.inject_prefilled(handoff, _handle=_handle)

    def run_until_idle(self):
        self.decode.run_until_idle()

    def start(self):
        self.decode.start()
        return self

    def stop(self):
        self.decode.stop()

    def stats(self):
        dstats = self.decode.stats()
        return {
            "group_id": self.group_id,
            "members": [self.prefill._engine, self.decode._engine],
            "roles": {"prefill": self.prefill._engine,
                      "decode": self.decode._engine},
            "handoffs": self.handoffs,
            "kv_transfer_bytes": self.kv_transfer_bytes,
            "free_decode_slots": self.free_decode_slots(),
            "queue_depth": len(self.decode._pending),
            "headroom": self.headroom(),
            "prefill_executables": dstats["executables"]["prefill"],
        }


class ShardGroupFleet:
    """Route requests over groups (each a `DisaggPair`, or anything with
    ``submit`` / ``headroom`` / ``stats``): the most decode headroom
    wins, ties to the lowest group id."""

    def __init__(self, groups, metrics_registry=None):
        if not groups:
            raise ValueError("need at least one shard group")
        self.groups = list(groups)
        self._lock = _locks.named_lock("tp_serving.disagg.fleet")
        reg = metrics_registry or default_registry()
        self.metrics_registry = reg
        self._fleet_label = unique_instance_label("shard_fleet")
        lbl = ("fleet",)
        self._m_submitted = reg.counter(
            "shard_fleet_requests_total",
            "Requests routed across shard groups",
            labelnames=lbl).labels(self._fleet_label)
        reg.gauge(
            "shard_fleet_kv_transfer_bytes",
            "Total KV bytes moved prefill -> decode, fleet-wide",
            labelnames=lbl).labels(self._fleet_label).set_function(
                lambda: sum(g.kv_transfer_bytes for g in self.groups))

    @property
    def _submitted(self):
        return int(self._m_submitted.value)

    def submit(self, request, trace=None):
        with self._lock:
            group = max(self.groups,
                        key=lambda g: (g.headroom(), -g.group_id))
            self._m_submitted.inc()
        if trace is not None:       # duck-typed groups may not take it
            return group.submit(request, trace=trace)
        return group.submit(request)

    def run_until_idle(self):
        for g in self.groups:
            g.run_until_idle()

    def start(self):
        for g in self.groups:
            g.start()
        return self

    def stop(self):
        for g in self.groups:
            g.stop()

    def ready(self):
        return any(not g.decode.dead for g in self.groups)

    def stats(self):
        return {
            "submitted": self._submitted,
            "shard_groups": [g.stats() for g in self.groups],
            "kv_transfer_bytes": sum(g.kv_transfer_bytes
                                     for g in self.groups),
        }

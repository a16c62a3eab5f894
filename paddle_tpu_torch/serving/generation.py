"""Generation behind the serving front: engine replicas, slot-occupancy
admission, requeue-once fault tolerance, chunked token streaming.

Counterpart of `paddle_tpu.serving.generation`, over the port's
`generation.GenerationEngine`.

`GenerationReplica` wraps one `generation.GenerationEngine` on its own
background scheduler thread and honors the `incubate.fault` plan's
``kill_replica`` events (addressed by replica index; the ``request``
field is read as the decode step the replica dies at — a REAL
mid-generation death: slots hold half-generated sequences when it
fires).

`GenerationFleet` is the router: `submit` places each request on the
alive replica with the most free slots (continuous batching keeps every
engine's slots independently busy); a replica death hands its in-flight
AND queued requests back, each re-queued on a surviving replica exactly
ONCE (the stream emits a ``restart`` event and token indices begin
again at 0) — a request that watches two replicas die fails loudly,
mirroring the Router's discipline.  Admission is the engines'
slot-occupancy signal: when the chosen engine's pending queue is full,
`ShedError` propagates (HTTP 503 + Retry-After priced in measured
tokens/s).

``/stats`` carries the paged-KV gauges per replica — block-pool
used/free, prefix-cache hit rate, speculative acceptance, preemptions —
the signals the capacity dashboard and the pool-sizing loop read.

`serve_generation_http` is the data plane: ``POST /generate`` with
``"stream": true`` answers ``application/x-ndjson`` over chunked
transfer encoding — one JSON object per token as it is decoded (the
TTFT the engine worked for actually reaches the client), terminated by
a ``{"done": ...}`` record; ``GET /slo`` reports the fleet's SLO
engine and ``GET /trace`` the tracer's timeline.  (The reference's
``serving.serve_http`` also mounts the handler next to its router's
/predict; the router is not ported yet.)

Lock discipline: the fleet lock (level ``router``) is never held across
``engine.submit``, because a dying engine calls the fleet's hook under
its own lock; the hook requeues on a fresh thread.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np

from ..generation import (
    EngineDeadError,
    GenerationEngine,
    GenerationRequest,
    SamplingParams,
)
from ..observability import locks as _locks
from ..observability import trace as _trace
from ..observability.metrics import default_registry, unique_instance_label
from .admission import ShedError
from .http_common import JsonHandlerMixin, standard_get_plane

__all__ = [
    "GenerationFleet",
    "GenerationReplica",
    "handle_generate",
    "handle_slo",
    "handle_trace",
    "parse_generation_request",
    "serve_generation_http",
]


class GenerationReplica:
    """One engine + its scheduler thread + the fault-drill seam."""

    def __init__(self, model, index=0, fleet_name="genfleet",
                 fault_plan=None, **engine_kwargs):
        self.index = int(index)
        self.replica_id = "%s/g%d" % (fleet_name, self.index)
        if fault_plan is None:
            from ..incubate.fault import FaultPlan

            fault_plan = FaultPlan.from_env()
        kill_at = fault_plan.replica_kill_request(self.index)
        stall = fault_plan.replica_stall(self.index)
        stalled = [False]              # one-shot latch

        def hook(step_no):
            if stall is not None and not stalled[0] \
                    and step_no + 1 >= stall[0]:
                # injected latency (the SLO drill): the decode step
                # stalls ONCE, inflating ITL for in-flight requests
                stalled[0] = True
                # sanctioned: the stall deliberately blocks under the
                # engine lock — that latency spike IS the drill
                with _locks.sanctioned():
                    time.sleep(stall[1])
            if kill_at is not None and step_no + 1 >= kill_at:
                raise EngineDeadError(
                    "%s: injected death at decode step %d"
                    % (self.replica_id, step_no + 1))

        self.engine = GenerationEngine(
            model, name=self.replica_id,
            step_hook=(hook if (kill_at is not None or stall is not None)
                       else None),
            **engine_kwargs)

    @property
    def alive(self):
        return not self.engine.dead

    def start(self):
        self.engine.start()
        return self

    def stop(self):
        self.engine.stop()

    def free_slots(self):
        occ = self.engine.occupancy()
        return occ["free"] - occ["pending"]

    def describe(self):
        st = self.engine.stats()
        d = {"replica_id": self.replica_id, "alive": self.alive,
             **self.engine.occupancy(),
             # the paged-KV gauges the admission/capacity dashboards
             # read off /stats: pool fill, prefix reuse, draft yield
             "kv_cache": st["cache"],
             "preempted": st["preempted"]}
        for k in ("prefix_cache", "speculative"):
            if k in st:
                d[k] = st[k]
        return d


class GenerationFleet:
    """See module docstring."""

    def __init__(self, model, replicas=1, *, name="genfleet",
                 metrics_registry=None, fault_plan=None,
                 slo=None, slo_objectives=None, **engine_kwargs):
        reg = metrics_registry or default_registry()
        self.metrics_registry = reg
        self.name = name
        self._fleet = unique_instance_label(name)
        # router-level fleet lock: NEVER held across engine.submit
        # (see submit() — the engine-death requeue path nests the
        # other way)
        self._lock = _locks.named_rlock(
            "serving.generation.fleet", level="router")
        if fault_plan is not None:
            # lock_delay events widen declared race windows for the
            # whole drill (observability.locks.install_delays)
            fault_plan.arm_lock_delays()
        # the fleet's SLO engine: every replica's per-request records
        # flow into its rolling window (GET /slo, serving_ctl slo, the
        # regression sentinel's live summary)
        if slo is None:
            from ..observability.slo import SLOEngine

            slo = SLOEngine(slo_objectives, registry=reg,
                            name=self._fleet)
        self.slo = slo
        engine_kwargs.setdefault("request_sink", self.slo.record)
        self.replicas = []
        for i in range(int(replicas)):
            r = GenerationReplica(model, index=i, fleet_name=self._fleet,
                                  fault_plan=fault_plan,
                                  metrics_registry=reg, **engine_kwargs)
            r.engine.on_death = self._on_engine_death
            self.replicas.append(r)
        self._m_requests = reg.counter(
            "generation_fleet_requests_total", "Fleet requests",
            labelnames=("fleet",)).labels(self._fleet)
        self._m_requeued = reg.counter(
            "generation_fleet_requeued_total",
            "Requests re-queued after a replica death",
            labelnames=("fleet",)).labels(self._fleet)
        self._m_deaths = reg.counter(
            "generation_fleet_replica_deaths_total", "Replica deaths",
            labelnames=("fleet",)).labels(self._fleet)
        self._m_failed = reg.counter(
            "generation_fleet_failed_total",
            "Requests failed after surviving-death budget exhausted",
            labelnames=("fleet",)).labels(self._fleet)

    def start(self):
        for r in self.replicas:
            r.start()
        return self

    def stop(self):
        for r in self.replicas:
            r.stop()

    # -- routing -----------------------------------------------------------
    def _alive(self):
        return [r for r in self.replicas if r.alive]

    def submit(self, request, _handle=None):
        """Route to the alive replica with the most free slots.  Raises
        `ShedError` when every alive replica's queue is full (the
        admission signal), RuntimeError when none is alive."""
        if not isinstance(request, GenerationRequest):
            request = GenerationRequest(request)
        # no fleet-wide lock across engine.submit: a dying engine's
        # requeue callback takes the fleet path while still holding its
        # own engine lock, so nesting fleet-lock -> engine-lock here
        # would deadlock against engine-lock -> fleet-path there
        alive = self._alive()
        if not alive:
            raise RuntimeError(
                "generation fleet %s has no alive replicas" % self._fleet)
        last_shed = None
        for r in sorted(alive, key=lambda r: -r.free_slots()):
            try:
                h = r.engine.submit(request, _handle=_handle)
            except (ShedError, EngineDeadError) as e:
                last_shed = e
                continue
            if _handle is None:
                self._m_requests.inc()
            return h
        if isinstance(last_shed, ShedError):
            raise last_shed
        raise RuntimeError(
            "generation fleet %s: all replicas refused: %s"
            % (self._fleet, last_shed))

    # -- death / requeue-once ---------------------------------------------
    def _on_engine_death(self, engine, affected):
        """`engine.on_death` hook: the requeue-once discipline on whole
        generations — every affected request restarts ONCE on a
        surviving replica; a twice-unlucky request fails loudly.  Runs
        the requeue on a fresh thread: the hook fires under the dying
        engine's lock, and requeueing must take other locks."""
        self._m_deaths.inc()
        _trace.instant("generation.replica_death", cat="generation",
                       args={"fleet": self._fleet,
                             "affected": len(affected)})
        t = threading.Thread(target=self._requeue_affected,
                             args=(affected,),
                             name="genfleet-requeue", daemon=True)
        t.start()

    def _requeue_affected(self, affected):
        for handle in affected:
            if handle.requeued:
                self._m_failed.inc()
                handle._fail(
                    "request %s lost a second replica mid-generation"
                    % handle.request.request_id)
                continue
            handle.requeued = True
            handle._restart()
            try:
                self.submit(handle.request, _handle=handle)
                self._m_requeued.inc()
            except Exception as e:
                self._m_failed.inc()
                handle._fail(
                    "requeue after replica death failed: %s: %s"
                    % (type(e).__name__, e))

    # -- weight hot-swap ---------------------------------------------------
    def swap_params(self, params, replica_ids=None):
        """Hot-swap serving weights on alive replicas (all of them, or
        the subset named by ``replica_ids`` — the canary seam).
        ``params`` as `GenerationEngine.swap_params` takes them: the
        model's ``state_dict`` names and layout (JAX weights go through
        `models.from_jax_state_dict`).  A replica's first swap gives it
        its own copy of the weights; the others keep serving the shared
        module.  Returns the replica ids actually swapped; raises if
        none were."""
        swapped = []
        for r in self._alive():
            if replica_ids is not None and r.replica_id not in replica_ids:
                continue
            r.engine.swap_params(params)
            swapped.append(r.replica_id)
        if not swapped:
            raise RuntimeError(
                "generation fleet %s: no alive replica matched swap"
                % self._fleet)
        return swapped

    def snapshot_params(self):
        """Rollback point: CPU copies of the first alive replica's
        weights (replicas only ever diverge mid-canary)."""
        alive = self._alive()
        if not alive:
            raise RuntimeError(
                "generation fleet %s has no alive replicas" % self._fleet)
        return alive[0].engine.snapshot_params()

    # -- observability -----------------------------------------------------
    def ready(self):
        return bool(self._alive())

    def stats(self):
        return {
            "fleet": self._fleet,
            "ready": self.ready(),
            "replicas": [r.describe() for r in self.replicas],
            "slot_occupancy": self.slot_occupancy(),
        }

    def slot_occupancy(self):
        """Fleet-wide occupied-slot fraction — the admission signal the
        front exposes."""
        total = active = 0
        for r in self.replicas:
            occ = r.engine.occupancy()
            total += occ["slots"]
            active += occ["active"]
        return (active / total) if total else 0.0

    def live_summary(self):
        """SLO-window headline numbers + the fleet's decode launch
        signatures (the reference's compile count) — the
        `RegressionSentinel.check` input."""
        s = self.slo.live_summary()
        s["decode_executables"] = max(
            (r.engine._decode_cache_size() for r in self.replicas),
            default=0)
        return s


# ---------------------------------------------------------------------------
# HTTP front
# ---------------------------------------------------------------------------


def parse_generation_request(msg):
    """``POST /generate`` body -> `GenerationRequest` (shared by both
    HTTP fronts so the two accept byte-identical payloads)."""
    prompt = msg.get("prompt")
    if not isinstance(prompt, (list, tuple)) or not prompt:
        raise ValueError('body needs a non-empty "prompt" token list')
    sampling = SamplingParams(
        temperature=float(msg.get("temperature", 0.0)),
        top_k=int(msg.get("top_k", 0)),
        top_p=float(msg.get("top_p", 1.0)),
        seed=int(msg.get("seed", 0)))
    return GenerationRequest(
        np.asarray(prompt, np.int64),
        max_new_tokens=int(msg.get("max_new_tokens", 16)),
        sampling=sampling,
        stop_token_ids=tuple(msg.get("stop", ())),
        request_id=msg.get("request_id"))


def handle_generate(handler, fleet, msg):
    """Answer one /generate on an open BaseHTTPRequestHandler.  With
    ``"stream": true`` the response is chunked ndjson — one record per
    event as it happens; otherwise one JSON object after completion."""
    try:
        request = parse_generation_request(msg)
        stream = bool(msg.get("stream", True))
        timeout = float(msg.get("timeout", 60.0))
    except Exception as e:
        handler._send(400, {"error": "%s: %s" % (type(e).__name__, e)})
        return
    try:
        h = fleet.submit(request)
    except ShedError as e:
        handler._send(503, {"error": str(e), "shed": True,
                            "reason": e.reason},
                      headers=(("Retry-After", str(e.retry_after_s)),))
        return
    except ValueError as e:
        handler._send(400, {"error": "%s: %s" % (type(e).__name__, e)})
        return
    except Exception as e:
        handler._send(500, {"error": "%s: %s" % (type(e).__name__, e)})
        return
    if not stream:
        try:
            tokens = h.result(timeout=timeout)
        except Exception as e:
            handler._send(500, {"error": "%s: %s" % (type(e).__name__, e)})
            return
        handler._send(200, {"tokens": tokens,
                            "reason": h.finish_reason,
                            "request_id": request.request_id})
        return
    # chunked ndjson stream (requires the handler to speak HTTP/1.1)
    handler.send_response(200)
    handler.send_header("Content-Type", "application/x-ndjson")
    handler.send_header("Transfer-Encoding", "chunked")
    handler.send_header("X-Request-Id", request.request_id)
    handler.end_headers()

    def chunk(obj):
        body = (json.dumps(obj) + "\n").encode()
        handler.wfile.write(b"%x\r\n" % len(body) + body + b"\r\n")

    try:
        try:
            for ev in h.events(timeout=timeout):
                kind = ev[0]
                if kind == "token":
                    rec = {"index": ev[1], "token": ev[2]}
                    if len(ev) > 3:    # logprob engines append a field;
                        rec["logprob"] = ev[3]   # off => byte-identical
                    chunk(rec)
                elif kind == "restart":
                    chunk({"event": "restart"})
                elif kind == "done":
                    chunk({"done": True, "reason": ev[1],
                           "n_tokens": len(h._tokens)})
                else:
                    chunk({"done": True, "error": ev[1]})
        except TimeoutError as e:
            # the stream ALWAYS ends with a terminal record — a stalled
            # request must not leave the client hanging on a dead chunk
            chunk({"done": True, "error": str(e)})
        handler.wfile.write(b"0\r\n\r\n")
    except BrokenPipeError:
        pass                       # client went away mid-stream


def handle_slo(handler, slo):
    """Answer GET /slo: evaluate the rolling window now (gauges and
    latched alerts update as a side effect)."""
    if slo is None:
        handler._send(404, {"error": "no SLO engine attached"})
        return
    handler._send(200, slo.report())


def handle_trace(handler, path):
    """Answer GET /trace: this process's tracer shard, anchor-aligned,
    optionally filtered by ``?trace_id=``.  409 while tracing is
    disabled — same contract as the classic InferenceServer front."""
    import urllib.parse

    tr = _trace.default_tracer()
    if not tr.enabled:
        handler._send(409, {
            "error": "tracing disabled; enable with "
                     "observability.enable_tracing() or "
                     "PADDLE_TPU_TRACE=1"})
        return
    qs = urllib.parse.urlparse(path).query
    tid = (urllib.parse.parse_qs(qs).get("trace_id") or [None])[0]
    handler._send(200, _trace.merge_fleet_trace([tr.chrome_trace()],
                                                trace_id=tid))


def serve_generation_http(fleet, host="127.0.0.1", port=8090, block=True):
    """The dedicated generation data plane: POST /generate (streamed or
    not), /healthz, /readyz, /stats, /metrics, /slo, /trace.  Returns
    the HTTPServer."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(JsonHandlerMixin, BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"    # chunked needs 1.1

        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path.split("?", 1)[0] == "/slo":
                handle_slo(self, getattr(fleet, "slo", None))
                return
            if self.path.split("?", 1)[0] == "/trace":
                handle_trace(self, self.path)
                return
            if not standard_get_plane(
                    self, self.path, ready_fn=fleet.ready,
                    stats_fn=fleet.stats,
                    registry=fleet.metrics_registry,
                    not_ready_reason="no alive replicas"):
                self._send(404, {"error": "unknown path %r" % self.path})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "unknown path %r" % self.path})
                return
            try:
                msg = self._body()
            except Exception as e:
                self._send(400, {"error": "%s: %s"
                                 % (type(e).__name__, e)})
                return
            handle_generate(self, fleet, msg)

    httpd = ThreadingHTTPServer((host, port), Handler)
    if block:
        httpd.serve_forever()
    else:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
    return httpd

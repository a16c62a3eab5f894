"""Token-level SLO engine + serving regression sentinel.

Counterpart of `paddle_tpu.observability.slo`, the same code but for
the platform probe.  The metrics registry answers "how is the system
doing" with cumulative counters and histograms; an SLO needs the
distribution of the LAST N requests — a p99 over a rolling window, not
over the process lifetime — plus a judgment: is the fleet meeting its
objectives RIGHT NOW, and how fast is it burning error budget if not.

* `Objective` — one declarative target: a metric (``ttft_ms`` /
  ``itl_ms`` latencies at a percentile, or ``shed`` / ``error`` rates)
  and a threshold.  `default_objectives()` builds the standard serving
  quartet (TTFT p99, ITL p99, shed rate, error rate).
* `SLOEngine` — rolling window of per-request records (what
  `GenerationEngine` emits through ``request_sink``), evaluated on
  demand: per-objective values + pass/fail, **goodput** (fraction of
  requests meeting ALL objectives — the DistServe framing), and
  multi-window **burn rates** (bad-fraction / error-budget, the SRE
  alerting idiom: burn 1.0 = exactly spending budget, >>1 = on fire).
  Alerts latch: firing emits a registry counter + a tracer instant
  (which the flight recorder's ring dumps on crash) + a gauge flip;
  recovery emits the clearing instant.
* `RegressionSentinel` — the deploy-time judge: compares the live
  window against a pinned BENCH_*.json baseline, platform-matched (a
  CPU smoke number can never gate a GPU fleet, and vice versa), and
  flips a ``serving_regression`` gauge.  `gate()` adapts a verdict
  into the callable `ModelRegistry.promote(slo_gate=...)` accepts, so
  a canary burning budget auto-rejects with the old version untouched.

Everything here is stdlib-only but the sentinel's platform probe,
which imports torch when it runs: ``"gpu"`` where a CUDA device is
present, else ``"cpu"``.
"""

from __future__ import annotations

import json
import time
from collections import deque

from . import locks

__all__ = [
    "Objective",
    "SLOEngine",
    "RegressionSentinel",
    "default_objectives",
    "percentile",
]

# metric kinds: percentile-over-latency vs fraction-of-outcomes
_LATENCY_METRICS = ("ttft_ms", "itl_ms", "duration_ms")
_RATE_METRICS = ("shed", "error")


def percentile(values, q):
    """Nearest-rank percentile (q in [0, 100]) — deterministic, no
    interpolation, so hand oracles in tests are exact."""
    if not values:
        return None
    vs = sorted(values)
    if q <= 0:
        return vs[0]
    if q >= 100:
        return vs[-1]
    # nearest-rank: ceil(q/100 * N), 1-indexed
    rank = -(-q * len(vs) // 100)          # ceil without float drift
    return vs[int(rank) - 1]


class Objective:
    """One declarative serving objective.

    metric: ``ttft_ms`` / ``itl_ms`` / ``duration_ms`` (milliseconds,
    judged at `percentile`) or ``shed`` / ``error`` (window fraction
    in [0, 1]; `percentile` unused).  An objective over an empty
    window is vacuously met.
    """

    __slots__ = ("name", "metric", "threshold", "percentile")

    def __init__(self, name, metric, threshold, percentile=None):
        if metric not in _LATENCY_METRICS + _RATE_METRICS:
            raise ValueError("unknown SLO metric %r (expected one of %s)"
                             % (metric,
                                _LATENCY_METRICS + _RATE_METRICS))
        if metric in _LATENCY_METRICS and percentile is None:
            percentile = 99.0
        self.name = str(name)
        self.metric = metric
        self.threshold = float(threshold)
        self.percentile = None if percentile is None else float(percentile)

    def describe(self):
        d = {"name": self.name, "metric": self.metric,
             "threshold": self.threshold}
        if self.percentile is not None:
            d["percentile"] = self.percentile
        return d

    def __repr__(self):
        return "Objective(%r, %r, %r)" % (self.name, self.metric,
                                          self.threshold)


def default_objectives(ttft_ms_p99=500.0, itl_ms_p99=100.0,
                       shed_rate=0.05, error_rate=0.01):
    """The standard serving quartet (thresholds are smoke-scale
    defaults; production fleets pass their own)."""
    return [
        Objective("ttft_p99", "ttft_ms", ttft_ms_p99, percentile=99.0),
        Objective("itl_p99", "itl_ms", itl_ms_p99, percentile=99.0),
        Objective("shed_rate", "shed", shed_rate),
        Objective("error_rate", "error", error_rate),
    ]


class SLOEngine:
    """Rolling-window SLO evaluation over per-request records.

    A record is the dict `GenerationEngine` emits per finished request:
    ``{"request_id", "trace_id", "t_wall", "outcome"
    ("ok"|"shed"|"error"), "ttft_ms", "itl_ms", "n_tokens",
    "duration_ms"}`` — shed/error records carry None latencies and are
    excluded from percentile math but counted by the rate objectives.

    * goodput = fraction of windowed requests with outcome "ok" AND
      every latency objective individually met (not just the p99 —
      each request is judged against the thresholds);
    * burn_rate(w) = bad_fraction(records in the last w seconds)
      / (1 - target) — 1.0 means spending error budget exactly at the
      allowed rate.

    Thread-safe; `record` is O(1) (deque append) so the serving hot
    path pays nothing for evaluation it doesn't ask for.
    """

    def __init__(self, objectives=None, *, window=512, target=0.99,
                 burn_windows=(60.0, 600.0, 3600.0), registry=None,
                 name="serving", clock=time.time):
        self.objectives = list(objectives) if objectives is not None \
            else default_objectives()
        self.name = str(name)
        self.target = float(target)
        if not 0.0 < self.target < 1.0:
            raise ValueError("target must be in (0, 1): %r" % target)
        self.burn_windows = tuple(float(w) for w in burn_windows)
        self._clock = clock
        self._records = deque(maxlen=max(int(window), 8))
        self._lock = locks.named_lock("observability.slo.state")
        self._alerts = {}            # objective name -> fired-at t_wall
        if registry is None:
            from .metrics import default_registry

            registry = default_registry()
        self.registry = registry
        labels = ("slo",)
        self._m_alerts = registry.counter(
            "slo_alerts_total", "SLO alert firings", labels + ("objective",))
        self._g_goodput = registry.gauge(
            "slo_goodput", "fraction of windowed requests meeting every "
            "objective", labels)
        self._g_ok = registry.gauge(
            "slo_objective_ok", "1 when the objective is met over the "
            "window", labels + ("objective",))
        self._g_burn = registry.gauge(
            "slo_burn_rate", "error-budget burn rate per window",
            labels + ("window",))

    # -- ingest ----------------------------------------------------------
    def record(self, rec):
        """Append one per-request record (the ``request_sink``
        signature).  Fills in t_wall when the producer didn't."""
        if "t_wall" not in rec:
            rec = dict(rec, t_wall=self._clock())
        with self._lock:
            self._records.append(rec)

    def __len__(self):
        with self._lock:
            return len(self._records)

    # -- evaluate --------------------------------------------------------
    def _objective_value(self, obj, recs):
        if obj.metric in _RATE_METRICS:
            if not recs:
                return None
            bad = sum(1 for r in recs if r.get("outcome") == obj.metric)
            return bad / len(recs)
        vals = [r[obj.metric] for r in recs
                if r.get(obj.metric) is not None]
        return percentile(vals, obj.percentile)

    def _request_good(self, rec):
        """One request's pass/fail against every latency threshold —
        the goodput unit (DistServe's per-request framing)."""
        if rec.get("outcome") != "ok":
            return False
        for obj in self.objectives:
            if obj.metric in _RATE_METRICS:
                continue
            v = rec.get(obj.metric)
            if v is not None and v > obj.threshold:
                return False
        return True

    def evaluate(self, now=None):
        """Judge the window; update gauges; fire/clear latched alerts.
        Returns the full report dict (`GET /slo` payload)."""
        if now is None:
            now = self._clock()
        with self._lock:
            recs = list(self._records)
        objectives = []
        newly_fired, newly_cleared = [], []
        for obj in self.objectives:
            value = self._objective_value(obj, recs)
            ok = value is None or value <= obj.threshold
            d = obj.describe()
            d.update(value=value, ok=ok)
            objectives.append(d)
            self._g_ok.labels(self.name, obj.name).set(1.0 if ok else 0.0)
            fired_at = self._alerts.get(obj.name)
            if not ok and fired_at is None:
                self._alerts[obj.name] = now
                self._m_alerts.labels(self.name, obj.name).inc()
                newly_fired.append(d)
            elif ok and fired_at is not None:
                del self._alerts[obj.name]
                newly_cleared.append(d)
        n = len(recs)
        goodput = (sum(1 for r in recs if self._request_good(r)) / n) \
            if n else None
        if goodput is not None:
            self._g_goodput.labels(self.name).set(goodput)
        burn = {}
        for w in self.burn_windows:
            inw = [r for r in recs if now - r.get("t_wall", now) <= w]
            if inw:
                bad = sum(1 for r in inw if not self._request_good(r))
                rate = (bad / len(inw)) / (1.0 - self.target)
            else:
                rate = 0.0
            burn["%gs" % w] = rate
            self._g_burn.labels(self.name, "%gs" % w).set(rate)
        self._emit_transitions(newly_fired, newly_cleared)
        return {
            "slo": self.name,
            "window": n,
            "target": self.target,
            "objectives": objectives,
            "goodput": goodput,
            "burn_rate": burn,
            "alerts": sorted(self._alerts),
        }

    def _emit_transitions(self, fired, cleared):
        """Alert edges go into the tracer ring — the flight recorder
        dumps that ring on crash, so the last alerts ride along."""
        if not fired and not cleared:
            return
        try:
            from .trace import default_tracer

            tr = default_tracer()
            for d in fired:
                tr.instant("slo.alert", args={
                    "slo": self.name, "objective": d["name"],
                    "value": d["value"], "threshold": d["threshold"]},
                    scope="g", cat="slo")
            for d in cleared:
                tr.instant("slo.alert_cleared", args={
                    "slo": self.name, "objective": d["name"]},
                    scope="g", cat="slo")
        except Exception:
            pass

    def alerts(self):
        """Names of currently-latched alerts (post last evaluate)."""
        return sorted(self._alerts)

    def report(self):
        """Evaluate + return — the `GET /slo` / `serving_ctl slo`
        entry point."""
        return self.evaluate()

    # -- live summary for the sentinel -----------------------------------
    def live_summary(self):
        """The window's headline numbers in BENCH-comparable units
        (what `RegressionSentinel.check` consumes)."""
        with self._lock:
            recs = list(self._records)
        ttft = [r["ttft_ms"] for r in recs if r.get("ttft_ms") is not None]
        itl = [r["itl_ms"] for r in recs if r.get("itl_ms") is not None]
        toks = sum(r.get("n_tokens") or 0 for r in recs)
        secs = sum((r.get("duration_ms") or 0.0) for r in recs) / 1e3
        return {
            "window": len(recs),
            "ttft_ms_p99": percentile(ttft, 99.0),
            "itl_ms_p99": percentile(itl, 99.0),
            "tokens_per_s": (toks / secs) if secs > 0 else None,
        }


def _current_platform():
    """``"gpu"`` where torch sees a CUDA device, else ``"cpu"``."""
    import torch

    return "gpu" if torch.cuda.is_available() else "cpu"


class RegressionSentinel:
    """Deploy-time / periodic judge: live window vs pinned baseline.

    baseline: ``{"platform", "ttft_ms_p99", "itl_ms_p99",
    "tokens_per_s", "decode_executables"}`` — missing keys are simply
    not judged.  `from_bench_file` lifts these from a BENCH_*.json
    (flat ``{"metric", "value", "platform"}`` records).

    Platform matching is a hard precondition: when the baseline's
    platform differs from the live one the check returns
    ``checked=False`` and NEVER flips the gauge — a smoke capture can
    not gate a TPU fleet, nor the reverse (the PERF.md discipline).

    Regression rules (tolerance is a fraction, default 0.25):
      latency:     live > baseline * (1 + tolerance)
      throughput:  live < baseline * (1 - tolerance)
      compiles:    live > baseline  (any NEW executable is a finding)
    """

    _LATENCY_KEYS = ("ttft_ms_p99", "itl_ms_p99")
    _THROUGHPUT_KEYS = ("tokens_per_s",)
    _COUNT_KEYS = ("decode_executables",)

    def __init__(self, baseline, *, registry=None, tolerance=0.25,
                 name="serving", platform=None):
        self.baseline = dict(baseline)
        self.tolerance = float(tolerance)
        self.name = str(name)
        self.platform = platform or _current_platform()
        if registry is None:
            from .metrics import default_registry

            registry = default_registry()
        self.registry = registry
        self._g_regressed = registry.gauge(
            "serving_regression", "1 while the live window regresses "
            "the pinned baseline", ("sentinel",))
        self._m_checks = registry.counter(
            "serving_regression_checks_total", "sentinel comparisons",
            ("sentinel", "verdict"))

    @classmethod
    def from_bench_file(cls, path, **kw):
        """Build from a BENCH_*.json of flat metric records.  Records
        without a ``platform`` key (the TPU r04 schema predates it) are
        taken at the file's declared platform or "tpu"."""
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict):
            data = [data]
        baseline, platform = {}, None
        for rec in data:
            if not isinstance(rec, dict):
                continue
            platform = rec.get("platform", platform)
            m, v = rec.get("metric"), rec.get("value")
            if m in (cls._LATENCY_KEYS + cls._THROUGHPUT_KEYS
                     + cls._COUNT_KEYS) and v is not None:
                baseline[m] = v
        baseline["platform"] = platform or "tpu"
        return cls(baseline, **kw)

    def check(self, live):
        """Compare one live summary (`SLOEngine.live_summary()` shape)
        against the baseline; update the gauge; return the verdict."""
        base_platform = self.baseline.get("platform")
        if base_platform and base_platform != self.platform:
            self._m_checks.labels(self.name, "skipped").inc()
            return {"checked": False, "regressed": False,
                    "skipped": "baseline platform %r != live %r"
                               % (base_platform, self.platform)}
        findings = []
        tol = self.tolerance
        for k in self._LATENCY_KEYS:
            b, v = self.baseline.get(k), live.get(k)
            if b is not None and v is not None and v > b * (1 + tol):
                findings.append({"metric": k, "baseline": b, "live": v,
                                 "kind": "latency"})
        for k in self._THROUGHPUT_KEYS:
            b, v = self.baseline.get(k), live.get(k)
            if b is not None and v is not None and v < b * (1 - tol):
                findings.append({"metric": k, "baseline": b, "live": v,
                                 "kind": "throughput"})
        for k in self._COUNT_KEYS:
            b, v = self.baseline.get(k), live.get(k)
            if b is not None and v is not None and v > b:
                findings.append({"metric": k, "baseline": b, "live": v,
                                 "kind": "compile_count"})
        regressed = bool(findings)
        self._g_regressed.labels(self.name).set(1.0 if regressed else 0.0)
        self._m_checks.labels(
            self.name, "regressed" if regressed else "ok").inc()
        if regressed:
            try:
                from .trace import default_tracer

                default_tracer().instant("sentinel.regression", args={
                    "sentinel": self.name,
                    "findings": [f["metric"] for f in findings]},
                    scope="g", cat="slo")
            except Exception:
                pass
        return {"checked": True, "regressed": regressed,
                "findings": findings, "platform": self.platform}

    def gate(self, live_fn):
        """Adapt to the `ModelRegistry.promote(slo_gate=...)` contract:
        a zero-arg callable returning the verdict dict (`regressed` /
        `alerts` truthy -> reject).  live_fn: () -> live summary."""

        def _gate():
            return self.check(live_fn())

        return _gate

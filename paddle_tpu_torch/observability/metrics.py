"""Metric primitives + MetricsRegistry: the one always-on telemetry layer.

Capability parity: the reference kept live per-event aggregate rows in
`platform/profiler.cc` (calls/total/min/max per op) and named int64
counters in `platform/monitor.h` (StatRegistry), but each subsystem that
wanted production metrics grew its own island.  This module is the shared
substrate: labeled `Counter` / `Gauge` / `Histogram` families registered
in a `MetricsRegistry`, exported as Prometheus text exposition or a JSON
snapshot (see `observability.export`), scraped over HTTP, and aggregated
per-rank through `distributed.monitor.MetricsAggregator`.

Design notes (TPU-first, host-side):

* metrics are HOST objects — they never enter a jaxpr.  Instrumentation
  of device work records wall-clock around dispatch+materialization
  (`observability.step_timer`), which is the honest boundary under XLA's
  async dispatch;
* a metric constructed WITHOUT a registry is standalone (the
  serving counters worked this way and still do through the
  `fluid.profiler.Counter/Histogram` aliases); passing
  ``registry=...`` (or using the registry's `counter()/gauge()/
  histogram()` get-or-create constructors) makes it scrapeable;
* histograms keep BOTH exact aggregates + fixed cumulative buckets (the
  Prometheus exposition) AND a bounded seeded reservoir (algorithm R)
  for the p50/p95/p99 the serving `/stats` endpoint always reported.
  One implementation — the `fluid.profiler` and `io.stats` copies are
  aliases of this class in the JAX package.
"""

from __future__ import annotations

import itertools

from . import locks

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "DEFAULT_MS_BUCKETS",
]

# latency-in-milliseconds oriented default ladder (also fine for counts)
DEFAULT_MS_BUCKETS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, float("inf"),
)

_INF = float("inf")


def _check_labels(labelnames, labels):
    if set(labels) != set(labelnames):
        raise ValueError(
            "labels %s do not match declared labelnames %s"
            % (sorted(labels), sorted(labelnames)))


class _MetricBase:
    """Shared family/child mechanics.

    A metric with labelnames is a FAMILY: `labels(**kv)` returns (or
    creates) the child holding the actual series.  A metric without
    labelnames is its own single child.  Family and children share one
    lock — series creation and value mutation are both guarded by it.
    """

    type = "untyped"

    # summaries report this instead of the (family) name when set —
    # lets migrated call sites (serving /stats, PipelineStats) keep
    # their pre-registry names in summary() output
    display_name = None

    def __init__(self, name="", help="", labelnames=(), registry=None):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = locks.named_lock(
            "observability.metrics.family", level="metrics")
        self._children = {}          # labelvalues tuple -> child
        self._labelvalues = ()       # set on children
        self._is_child = False
        if registry is not None:
            registry.register(self)

    # -- family side -----------------------------------------------------
    def labels(self, *labelvalues, **labelkv):
        """Child for one label-value combination (get-or-create)."""
        if self._is_child:
            raise ValueError("labels() called on a child metric")
        if not self.labelnames and not labelvalues and not labelkv:
            return self          # unlabeled family IS its single series
        if labelvalues and labelkv:
            raise ValueError("pass label values positionally OR by name")
        if labelkv:
            _check_labels(self.labelnames, labelkv)
            key = tuple(str(labelkv[n]) for n in self.labelnames)
        else:
            if len(labelvalues) != len(self.labelnames):
                raise ValueError(
                    "expected %d label values %s, got %d"
                    % (len(self.labelnames), self.labelnames,
                       len(labelvalues)))
            key = tuple(str(v) for v in labelvalues)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                child.name = self.name
                child.help = self.help
                child.labelnames = self.labelnames
                child._labelvalues = key
                child._is_child = True
                child._lock = self._lock   # family-wide consistency
                self._children[key] = child
            return child

    def remove(self, *labelvalues):
        with self._lock:
            self._children.pop(tuple(str(v) for v in labelvalues), None)

    def _default_child(self):
        if self._is_child:
            return self
        if self.labelnames:
            raise ValueError(
                "metric %r has labels %s; call .labels(...) first"
                % (self.name, self.labelnames))
        return self              # unlabeled family IS its single series

    def _series(self):
        """[(labelvalues, child)] — every live series of this family."""
        if self._is_child or not self.labelnames:
            return [(self._labelvalues, self)]
        with self._lock:
            return sorted(self._children.items())

    def clear(self):
        """Zero state across the whole family (children stay
        registered)."""
        with self._lock:
            if self._is_child or not self.labelnames:
                self._reset_locked()
            for c in self._children.values():
                c._reset_locked()

    def _new_child(self):
        return type(self)(self.name, self.help)

    def _reset_locked(self):
        raise NotImplementedError


class Counter(_MetricBase):
    """Monotonic counter (thread-safe).  `inc()` only goes up."""

    type = "counter"

    def __init__(self, name="", help="", labelnames=(), registry=None):
        super().__init__(name, help, labelnames, registry)
        self._n = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        c = self._default_child()
        with c._lock:
            c._n += n

    @property
    def value(self):
        return self._default_child()._n

    def summary(self):
        """Back-compatible summary shape: {"name", "value"}."""
        return {"name": self.display_name or self.name,
                "value": self.value}

    def _reset_locked(self):
        self._n = 0


class Gauge(_MetricBase):
    """Point-in-time value; settable, incrementable, or callback-backed
    (`set_function` — sampled at scrape time, e.g. queue depth)."""

    type = "gauge"

    def __init__(self, name="", help="", labelnames=(), registry=None):
        super().__init__(name, help, labelnames, registry)
        self._v = 0.0
        self._fn = None

    def set(self, v):
        g = self._default_child()
        with g._lock:
            g._v = float(v)

    def inc(self, n=1):
        g = self._default_child()
        with g._lock:
            g._v += n

    def dec(self, n=1):
        self.inc(-n)

    def set_function(self, fn):
        """Read `fn()` at scrape time instead of stored state."""
        g = self._default_child()
        with g._lock:
            g._fn = fn
        return self

    @property
    def value(self):
        g = self._default_child()
        fn = g._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                return float("nan")
        return g._v

    def summary(self):
        return {"name": self.display_name or self.name,
                "value": self.value}

    def _reset_locked(self):
        self._v = 0.0
        # a callback gauge keeps its callback: reset zeroes STATE, not wiring


class Histogram(_MetricBase):
    """Thread-safe histogram: exact count/sum/min/max, fixed cumulative
    buckets (Prometheus exposition), and percentiles from a bounded
    seeded reservoir (algorithm R — bounded memory under unbounded
    traffic, deterministic in tests).
    """

    type = "histogram"

    def __init__(self, name="", help="", labelnames=(), registry=None,
                 buckets=None, max_samples=4096):
        import random

        super().__init__(name, help, labelnames, registry)
        b = tuple(float(x) for x in (buckets or DEFAULT_MS_BUCKETS))
        if list(b) != sorted(b):
            raise ValueError("histogram buckets must be sorted")
        if not b or b[-1] != _INF:
            b = b + (_INF,)
        self.buckets = b
        self._max = max(int(max_samples), 1)
        self._rng = random.Random(0x5eed)
        self._samples = []
        self._bucket_counts = [0] * len(b)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def _new_child(self):
        return Histogram(self.name, self.help, buckets=self.buckets,
                         max_samples=self._max)

    def observe(self, v):
        v = float(v)
        h = self._default_child()
        with h._lock:
            h.count += 1
            h.sum += v
            h.min = v if h.min is None else min(h.min, v)
            h.max = v if h.max is None else max(h.max, v)
            for i, ub in enumerate(h.buckets):
                if v <= ub:
                    h._bucket_counts[i] += 1
                    break
            if len(h._samples) < h._max:
                h._samples.append(v)
            else:
                j = h._rng.randrange(h.count)
                if j < h._max:
                    h._samples[j] = v

    def cumulative_buckets(self):
        """[(upper_bound, cumulative_count)] — the `_bucket{le=}` series."""
        h = self._default_child()
        with h._lock:
            out, acc = [], 0
            for ub, n in zip(h.buckets, h._bucket_counts):
                acc += n
                out.append((ub, acc))
            return out

    @staticmethod
    def _rank(s, p):
        k = min(len(s) - 1, max(0, int(round((p / 100.0) * (len(s) - 1)))))
        return s[k]

    def percentile(self, p):
        """p in [0, 100]; nearest-rank over the reservoir; None if empty."""
        h = self._default_child()
        with h._lock:
            if not h._samples:
                return None
            s = sorted(h._samples)
        return self._rank(s, p)

    def summary(self):
        """Back-compatible summary shape (count/sum/mean/min/max/p50/p95/
        p99)."""
        name = self.display_name or self.name
        h = self._default_child()
        with h._lock:  # one consistent snapshot, one sort
            if h.count == 0:
                return {"name": name, "count": 0}
            count, total = h.count, h.sum
            mn, mx = h.min, h.max
            s = sorted(h._samples)
        return {
            "name": name,
            "count": count,
            "sum": total,
            "mean": total / count,
            "min": mn,
            "max": mx,
            "p50": self._rank(s, 50),
            "p95": self._rank(s, 95),
            "p99": self._rank(s, 99),
        }

    def _reset_locked(self):
        self._samples = []
        self._bucket_counts = [0] * len(self.buckets)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Named collection of metric families; the scrape unit.

    `counter()/gauge()/histogram()` are get-or-create: the same name
    returns the same family (labelnames/type must agree — a mismatch is
    a bug and raises).  `snapshot()` and `prometheus_text()` (in
    `observability.export`) read every family under its own lock, so a
    scrape during heavy mutation sees per-metric-consistent values.
    """

    def __init__(self):
        self._lock = locks.named_lock(
            "observability.metrics.registry", level="metrics")
        self._metrics = {}           # name -> family

    # -- registration ----------------------------------------------------
    def register(self, metric):
        if not metric.name:
            raise ValueError("registered metrics need a non-empty name")
        with self._lock:
            cur = self._metrics.get(metric.name)
            if cur is metric:
                return metric
            if cur is not None:
                raise ValueError(
                    "metric %r already registered" % metric.name)
            self._metrics[metric.name] = metric
        return metric

    def unregister(self, name):
        with self._lock:
            self._metrics.pop(name, None)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            cur = self._metrics.get(name)
            if cur is not None:
                # labelnames may be omitted on later lookups of an
                # existing family; when GIVEN they must agree
                if type(cur) is not cls or (
                        tuple(labelnames)
                        and cur.labelnames != tuple(labelnames)):
                    raise ValueError(
                        "metric %r exists as %s%s; requested %s%s"
                        % (name, type(cur).__name__, cur.labelnames,
                           cls.__name__, tuple(labelnames)))
                return cur
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()):
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=None,
                  max_samples=4096):
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets, max_samples=max_samples)

    # -- read side -------------------------------------------------------
    def collect(self):
        """Families sorted by name (a stable scrape order)."""
        with self._lock:
            return [m for _, m in sorted(self._metrics.items())]

    def snapshot(self):
        """JSON-able dict of every series (see export.json_snapshot)."""
        from .export import json_snapshot

        return json_snapshot(self)

    def prometheus_text(self):
        """Prometheus text exposition (see export.prometheus_text)."""
        from .export import prometheus_text

        return prometheus_text(self)

    def reset(self):
        """Zero every metric's STATE (counts, sums, reservoirs); the
        families and their label children stay registered.  This is what
        `fluid.profiler.reset_profiler()` calls."""
        for m in self.collect():
            m.clear()

    def clear(self):
        """Forget every registered family entirely (test isolation)."""
        with self._lock:
            self._metrics.clear()


_default = MetricsRegistry()


def default_registry():
    """The process-wide registry every built-in subsystem reports to."""
    return _default


# monotonically unique instance-label values ("io", "io:1", "io:2", ...)
# so independent component instances (two InferenceServers, two
# PipelineStats) each own their series in the shared registry
_instance_seq = itertools.count()
_instance_lock = locks.named_lock(
    "observability.metrics.instance", level="metrics")
_instance_used = set()


def unique_instance_label(base):
    with _instance_lock:
        if base not in _instance_used:
            _instance_used.add(base)
            return base
        while True:
            cand = "%s:%d" % (base, next(_instance_seq))
            if cand not in _instance_used:
                _instance_used.add(cand)
                return cand


def release_instance_label(value):
    """Free a label value taken by `unique_instance_label` (component
    teardown: the name becomes reusable and the registry stops growing
    across create/destroy cycles)."""
    with _instance_lock:
        _instance_used.discard(value)

"""Telemetry the generation engine and the serving tier report through:
the jax-free `metrics` registry, named `locks`, the request `trace`
recorder and the `slo` engine, copied from `paddle_tpu.observability`
(``export`` backs the registry's snapshot and Prometheus text)."""

from . import locks, metrics, slo, trace  # noqa: F401
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    unique_instance_label,
)

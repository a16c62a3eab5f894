"""Telemetry the generation engine reports through: the jax-free
`metrics` registry, named `locks` and the request `trace` recorder,
copied from `paddle_tpu.observability` (``export`` backs the registry's
snapshot and Prometheus text)."""

from . import locks, metrics, trace  # noqa: F401
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    unique_instance_label,
)

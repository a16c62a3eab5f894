"""paddle_tpu_torch.serving — the generation half of `paddle_tpu.serving`.

* `GenerationFleet` / `GenerationReplica` — `generation.GenerationEngine`
  replicas behind one router: least-loaded routing, slot-occupancy
  admission (`ShedError`, 503 + Retry-After upstream), requeue-once
  after a replica death (`incubate.fault` ``kill_replica`` drills),
  weight hot-swap on all replicas or a canary subset, and an
  `observability.slo.SLOEngine` over every replica's request records;
* `serve_generation_http` — the HTTP front: streamed ``POST /generate``
  (chunked ndjson), /healthz, /readyz, /stats, /metrics, /slo, /trace
  (`tools/generation_ctl.py` drives it);
* `AdmissionController` — the SLO-aware shedding policy.

The router of /predict models, its registry, replicas and worker
processes, and ``serve_http`` need the port's `inference/` package and
are not ported yet.
"""

from .admission import AdmissionController, ShedError  # noqa: F401
from .generation import (  # noqa: F401
    GenerationFleet,
    GenerationReplica,
    handle_generate,
    handle_slo,
    handle_trace,
    parse_generation_request,
    serve_generation_http,
)

__all__ = [
    "AdmissionController",
    "GenerationFleet",
    "GenerationReplica",
    "ShedError",
    "handle_generate",
    "handle_slo",
    "handle_trace",
    "parse_generation_request",
    "serve_generation_http",
]

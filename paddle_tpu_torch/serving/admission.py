"""SLO-aware admission control: shed load BEFORE work is wasted.

Counterpart of `paddle_tpu.serving.admission`.  `ShedError` is the
generation engine's own class, re-exported: there is one, so the fleet
catches what an engine raises.

Overloaded queues fail in a characteristic way: every request is
admitted, every request waits longer than its client timeout, the
server burns full throughput producing answers nobody is waiting for,
and p99 explodes unboundedly (queue collapse).  The fix is to refuse at
the front door the moment the *estimated* queue delay exceeds what the
SLO allows, with `Retry-After` telling clients when capacity should
exist again — a 503 in 100us is cheaper than a doomed 30s success.

The delay estimate needs no model: the router already measures, via the
metrics counters, how many rows it completed and how many
replica-seconds it spent completing them.  rows/second x alive replicas
is the fleet's service rate; queued rows / service rate is the expected
wait of the LAST request in line — exactly the number to compare
against the SLO.

Three independent shed conditions (reason label on the 503 and the
`serving_fleet_shed_total` counter):

* ``queue_full``  — total queued rows hit the hard bound (bounded
  memory regardless of SLO math);
* ``slo``         — estimated wait exceeds ``slo_ms``;
* ``version_cap`` — per-version concurrency cap: one version's burst
  (e.g. a canary hot spot) cannot occupy the whole admission queue.
"""

from __future__ import annotations

from ..generation.engine import ShedError

__all__ = ["AdmissionController", "ShedError"]


class AdmissionController:
    """Pure policy: the router feeds it queue depths and measured service
    rates; it answers admit/shed.  Holds no locks and no state beyond
    its configuration, so it is trivially swappable.

    * ``max_queue_rows``: hard bound on total queued rows (None: off).
    * ``slo_ms``: target queueing delay; admission rejects when the
      estimated wait for a NEW request exceeds it (None: off).
    * ``max_version_rows``: bound on any single version's
      queued+in-flight rows (None: off).
    """

    def __init__(self, max_queue_rows=4096, slo_ms=None,
                 max_version_rows=None):
        self.max_queue_rows = (None if max_queue_rows is None
                               else max(1, int(max_queue_rows)))
        self.slo_ms = None if slo_ms is None else float(slo_ms)
        self.max_version_rows = (None if max_version_rows is None
                                 else max(1, int(max_version_rows)))

    def describe(self):
        return {"max_queue_rows": self.max_queue_rows,
                "slo_ms": self.slo_ms,
                "max_version_rows": self.max_version_rows}

    def check(self, rows, total_queued_rows, version_rows,
              service_rate_rows_per_s):
        """Raise ShedError iff this request must be refused.

        rows: this request's batch rows; total_queued_rows: fleet-wide
        queued rows before this request; version_rows: target version's
        queued+in-flight rows; service_rate_rows_per_s: measured fleet
        service rate (0.0 when nothing has completed yet — a cold
        fleet admits, it has no evidence of overload)."""
        rate = max(float(service_rate_rows_per_s), 0.0)

        def _eta(backlog_rows):
            # how long until `backlog_rows` rows have drained
            return (backlog_rows / rate) if rate > 0 else 1.0

        if (self.max_queue_rows is not None
                and total_queued_rows + rows > self.max_queue_rows):
            raise ShedError(
                "queue_full", _eta(total_queued_rows),
                "queue %d + %d rows > bound %d"
                % (total_queued_rows, rows, self.max_queue_rows))
        if self.max_version_rows is not None \
                and version_rows + rows > self.max_version_rows:
            raise ShedError(
                "version_cap", _eta(version_rows),
                "version backlog %d + %d rows > cap %d"
                % (version_rows, rows, self.max_version_rows))
        if self.slo_ms is not None and rate > 0:
            est_wait_ms = (total_queued_rows + rows) / rate * 1e3
            if est_wait_ms > self.slo_ms:
                # retry once the EXCESS over the SLO has drained
                excess_rows = (est_wait_ms - self.slo_ms) / 1e3 * rate
                raise ShedError(
                    "slo", _eta(excess_rows),
                    "estimated queue delay %.1fms > slo %.1fms"
                    % (est_wait_ms, self.slo_ms))

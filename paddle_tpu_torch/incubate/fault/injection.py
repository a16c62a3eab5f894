"""`FaultPlan`: the fault schedule behind `paddle_tpu_torch.incubate.fault`.

Counterpart of the serving half of `paddle_tpu.incubate.fault.injection`:
the events a generation fleet reads (``kill_replica``,
``stall_replica``) and the named-lock delays (``lock_delay``).  The
training-side seams (rank kills, the faulty checkpoint filesystem, the
heartbeat staller) have no user in the port yet.

Deterministic: every fault fires at a declared replica and decode step,
never at random, so a failing drill reproduces every run.  The plan
serializes to JSON in $PADDLE_TPU_FAULT_PLAN, the reference's variable.
"""

from __future__ import annotations

import json
import os

FAULT_PLAN_ENV = "PADDLE_TPU_FAULT_PLAN"

__all__ = ["FAULT_PLAN_ENV", "FaultPlan"]


class FaultPlan:
    """A declarative schedule of faults for one drill.

    Event kinds:

      {"kind": "kill_replica", "replica": i, "request": n}
          replica i of a `serving.GenerationFleet` dies before its n-th
          decode step (1-based): a real mid-generation death, its slots
          holding half-generated streams (`replica_kill_request`).
      {"kind": "stall_replica", "replica": i, "step": n,
       "seconds": 0.2}
          replica i stalls ONCE for `seconds` (float) before decode
          step n — the injected tail latency the SLO engine must catch
          (`replica_stall`).
      {"kind": "lock_delay", "rank": r, "lock": "serving.generation.fleet",
       "seconds": 0.05, "times": k}
          the named registry lock (`observability.locks`) sleeps
          `seconds` right after each of its next `k` acquisitions on
          rank r, widening a race window deterministically
          (`arm_lock_delays`).

    Every event also takes `"gen": g` (default 0): it fires only in that
    elastic generation.  Replica events are addressed by replica index,
    independent of this process's rank.
    """

    def __init__(self, events=None, rank=None, generation=None):
        self.events = [dict(e) for e in (events or [])]
        if rank is None:
            rank = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        if generation is None:
            generation = int(os.getenv("PADDLE_ELASTIC_GENERATION", "0"))
        self.rank = int(rank)
        self.generation = int(generation)

    # -- construction -----------------------------------------------------
    @classmethod
    def from_env(cls, rank=None, generation=None):
        raw = os.getenv(FAULT_PLAN_ENV, "")
        if not raw:
            return cls([], rank=rank, generation=generation)
        return cls(json.loads(raw), rank=rank, generation=generation)

    def to_env(self, env=None):
        """Serialize into an env dict for a drill worker subprocess."""
        env = dict(env if env is not None else {})
        env[FAULT_PLAN_ENV] = json.dumps(self.events)
        return env

    def add(self, kind, **fields):
        self.events.append({"kind": kind, **fields})
        return self

    def _mine(self, kind):
        """Events of `kind` addressed to this rank and this elastic
        generation."""
        return [
            e for e in self.events
            if e.get("kind") == kind
            and int(e.get("rank", -1)) == self.rank
            and int(e.get("gen", 0)) == self.generation
        ]

    def _replica_event(self, kind, replica_index):
        for e in self.events:
            if (e.get("kind") == kind
                    and int(e.get("replica", -1)) == int(replica_index)
                    and int(e.get("gen", 0)) == self.generation):
                return e
        return None

    # -- serving-replica faults -------------------------------------------
    def replica_kill_request(self, replica_index):
        """The 1-based decode step at which generation replica
        `replica_index` dies (None: never)."""
        e = self._replica_event("kill_replica", replica_index)
        return None if e is None else int(e.get("request", 1))

    def replica_stall(self, replica_index):
        """The ``(decode_step, seconds)`` at which generation replica
        `replica_index` stalls once (None: never)."""
        e = self._replica_event("stall_replica", replica_index)
        return None if e is None else (int(e.get("step", 1)),
                                       float(e.get("seconds", 0.1)))

    # -- lock-seam faults -------------------------------------------------
    def lock_delays(self):
        """This rank's ``lock_delay`` events, normalized for
        ``observability.locks.install_delays``."""
        return [
            {"lock": str(e.get("lock", "")),
             "seconds": float(e.get("seconds", 0.0)),
             "times": int(e.get("times", 1))}
            for e in self._mine("lock_delay")
        ]

    def arm_lock_delays(self, registry=None):
        """Arm this plan's ``lock_delay`` events on the named-lock
        registry (the process-wide default unless given).  Returns the
        armed event count."""
        events = self.lock_delays()
        if events:
            from ...observability import locks

            (registry or locks.registry()).install_delays(events)
        return len(events)

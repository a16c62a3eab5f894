"""Deterministic fault injection for the serving drills: one declarative
`FaultPlan` that serializes through an environment variable, so a
drill replays the same schedule every run."""

from .injection import FAULT_PLAN_ENV, FaultPlan  # noqa: F401

"""Fault injection (faults.py), bounded retry (retry.py), the step
guard (guard.py) and checkpoint manifests (manifest.py)."""

from . import guard, manifest
from .faults import (FaultInjected, FaultPlan, active_plan, crash_point,
                     fire, reset)
from .guard import GuardConfigError, RollbackSignal, StepAnomalyError
from .manifest import VerificationError
from .retry import RetryPolicy, resilient_reader, retry_call

__all__ = ["guard", "manifest", "FaultInjected", "FaultPlan", "active_plan",
           "crash_point", "fire", "reset", "GuardConfigError",
           "RollbackSignal", "StepAnomalyError", "VerificationError",
           "RetryPolicy", "resilient_reader", "retry_call"]

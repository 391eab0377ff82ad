"""Fault injection (faults.py) and bounded retry (retry.py)."""

from .faults import (FaultInjected, FaultPlan, active_plan, crash_point,
                     fire, reset)
from .retry import RetryPolicy, resilient_reader, retry_call

__all__ = ["FaultInjected", "FaultPlan", "active_plan", "crash_point",
           "fire", "reset", "RetryPolicy", "resilient_reader", "retry_call"]

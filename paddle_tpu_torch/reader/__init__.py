"""Length bucketing."""

from .bucketing import bucket_bound

__all__ = ["bucket_bound"]

"""Tracing (span core)."""

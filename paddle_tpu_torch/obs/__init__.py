"""Tracing (span core) and the metrics plane (registry, Prometheus
exposition)."""

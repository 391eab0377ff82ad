"""Serving: the decode engine (``serving.decode``), admission control and
metrics. The one-shot ``ServingEngine`` facade, its HTTP front end and the
Prometheus exposition are not ported yet."""

"""The unified metrics plane: one registry, one Prometheus renderer.

Counterpart of ``paddle_tpu/obs/metrics.py``:

  MetricsRegistry   process-wide, weakref-valued registry of metric
                    providers grouped into SECTIONS (data / train /
                    model). A provider is anything with `.snapshot() ->
                    dict`. Weak references: an abandoned provider must
                    not be pinned (or keep reporting) because it once
                    registered.
  render_prometheus the ONE text-exposition renderer (version 0.0.4)
                    for every family: pt_serve_* / pt_decode_* /
                    pt_data_* / pt_train_* / pt_model_* (and the fleet,
                    calibration, elastic and orchestrator families the
                    JAX package's planes report). serving/metrics.py
                    re-exports it; the HTTP scrape
                    (`GET /v1/metrics?format=prometheus`) renders the
                    engine's snapshot through it.
  validate_exposition
                    conformance checker for the exposition format
                    (# TYPE present, label escaping, no duplicate
                    series).

Given one snapshot, the text is the JAX package's line for line except
``pt_build_info``, whose labels name what produced the numbers: the
torch version where the JAX package names its jax version, and the
card. ``TrainMetrics`` (the pt_train_* provider) comes with the Trainer.
"""

from __future__ import annotations

import os
import re
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional

__all__ = ["MetricsRegistry", "REGISTRY", "render_prometheus",
           "validate_exposition", "percentiles", "global_snapshot",
           "build_info_labels"]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Named sections of weakly-held metric providers. `snapshot()`
    merges every live provider into {section: {name: snapshot}} —
    the shape `render_prometheus` consumes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sections: Dict[str, "weakref.WeakValueDictionary"] = {}

    def register(self, section: str, name: str, provider) -> None:
        """Re-using a (section, name) replaces the previous registrant —
        a rebuilt pipeline/trainer is the same timeline to an operator,
        like a reloaded serving model."""
        with self._lock:
            sec = self._sections.get(section)
            if sec is None:
                sec = self._sections[section] = \
                    weakref.WeakValueDictionary()
            sec[name] = provider

    def register_unique(self, section: str, base_name: str,
                        provider) -> str:
        """Atomic register-if-absent: returns the name actually used —
        `base_name`, or the first free numeric-suffix variant when
        another LIVE provider already holds it. Unlike register(),
        concurrent callers can never silently shadow each other (the
        probe and the insert share one lock hold)."""
        with self._lock:
            sec = self._sections.get(section)
            if sec is None:
                sec = self._sections[section] = \
                    weakref.WeakValueDictionary()
            name, n = base_name, 1
            while sec.get(name) is not None \
                    and sec.get(name) is not provider:
                n += 1
                name = f"{base_name}-{n}"
            sec[name] = provider
            return name

    def unregister(self, section: str, name: str) -> None:
        with self._lock:
            sec = self._sections.get(section)
            if sec is not None:
                sec.pop(name, None)

    def providers(self, section: str) -> Dict[str, object]:
        with self._lock:
            sec = self._sections.get(section)
            return dict(sec) if sec is not None else {}

    def snapshot(self) -> Dict[str, Dict[str, dict]]:
        with self._lock:
            live = {s: dict(sec) for s, sec in self._sections.items()}
        out: Dict[str, Dict[str, dict]] = {}
        for section, providers in live.items():
            if not providers:
                continue
            out[section] = {name: p.snapshot()
                            for name, p in sorted(providers.items())}
        return out


#: the process-wide registry every plane reports through
REGISTRY = MetricsRegistry()


def global_snapshot() -> dict:
    """The registry's merged snapshot — what a scrape sees for the
    non-serving planes (serving merges this into its own snapshot)."""
    return REGISTRY.snapshot()


# ---------------------------------------------------------------------------
# shared percentile helper (was serving/metrics._percentiles)
# ---------------------------------------------------------------------------

def percentiles(samples: List[float],
                qs=(0.50, 0.95, 0.99)) -> Dict[str, Optional[float]]:
    """p50/p95/p99 by nearest-rank over a sorted copy, in ms."""
    if not samples:
        return {f"p{int(q * 100)}_ms": None for q in qs}
    s = sorted(samples)
    n = len(s)

    def rank(q: float) -> float:
        i = min(n - 1, max(0, int(round(q * (n - 1)))))
        return round(s[i] * 1000.0, 3)

    return {f"p{int(q * 100)}_ms": rank(q) for q in qs}


# ---------------------------------------------------------------------------
# Prometheus text exposition (version 0.0.4) — the ONE renderer
# ---------------------------------------------------------------------------

#: ModelMetrics counters exported as pt_serve_<key>; monotonic ones get
#: the conventional _total suffix
_SERVE_COUNTERS = ("received", "completed", "failed", "shed_overload",
                   "shed_deadline", "batches", "reloads")
_SERVE_GAUGES = ("queue_depth", "batch_fill_ratio", "qps")
_DECODE_COUNTERS = ("received", "completed", "failed", "shed_overload",
                    "shed_deadline", "evictions", "resumes", "prefills",
                    "prefill_tokens", "decode_steps", "tokens_out")
_DECODE_GAUGES = ("tokens_per_sec", "slot_occupancy", "active", "waiting",
                  "kv_blocks_in_use", "kv_blocks_capacity",
                  "kv_high_water")
#: KV-economics families (serving/decode/prefix.py + spec.py): prefix
#: sharing exports as pt_kv_*, speculative decoding as pt_spec_* —
#: snapshot keys carry the kv_/spec_ prefix already, so the family name
#: IS the key
_KV_COUNTERS = ("kv_shared_hits", "kv_shared_tokens", "kv_cow_copies")
_KV_GAUGES = ("kv_blocks_shared", "kv_blocks_indexed")
_SPEC_COUNTERS = ("spec_steps", "spec_drafted", "spec_accepted",
                  "spec_fallbacks")
_SPEC_GAUGES = ("spec_acceptance_rate",)
#: data-plane (input pipeline) counters/gauges exported as pt_data_*
#: (data/metrics.py PipelineMetrics.snapshot). wire_bytes/raw_bytes/
#: codec_ratio are the on-wire feed codec's accounting (data/codec.py)
_DATA_COUNTERS = ("batches", "samples")
_DATA_GAUGES = ("batches_per_sec", "samples_per_sec", "workers",
                "wire_bytes", "raw_bytes", "codec_ratio")
#: train-plane counters/gauges exported as pt_train_* (TrainMetrics)
_TRAIN_COUNTERS = ("steps", "examples", "epochs", "anomalies",
                   "rollbacks", "checkpoints", "compile_events")
_TRAIN_GAUGES = ("examples_per_sec", "steps_per_sec", "loss",
                 "grad_norm")
#: drift-monitor gauges exported as pt_model_* (obs/drift.py)
_MODEL_GAUGES = ("predicted_step_ms", "measured_step_ms", "drift_ratio",
                 "host_share_pct")
#: per-op attribution fields exported as pt_op_* (obs/opprof.py):
#: the coverage/total gauges per profiled program, plus the top-K
#: laggard rows by measured share
_OP_GAUGES = ("coverage_pct", "total_measured_ms", "fused_step_ms")
_OP_ROW_GAUGES = ("measured_ms", "predicted_ms", "share_pct", "mfu_pct")


#: (torch_version, detected_chip) memo — both are process constants.
#: The PT_COST_CHIP override stays live, so only the detection is cached.
_BUILD_INFO_MEMO: Optional[tuple] = None


def build_info_labels() -> Dict[str, str]:
    """Labels of the pt_build_info info-series: what produced the
    numbers a scrape carries — the torch version (the JAX package's
    ``jax`` label), the chip (PT_COST_CHIP override, else the card's
    name, read only when a card is present, else "cpu"), the armed
    PT_* knobs and the cost-model calibration. The value is a constant
    1; identity lives in the labels (the Prometheus build_info
    convention). ``knobs`` and ``calibration`` are "" until the flags
    registry and the calibration loop are ported."""
    global _BUILD_INFO_MEMO
    if _BUILD_INFO_MEMO is None:
        import torch
        try:
            detected = (torch.cuda.get_device_name(0)
                        if torch.cuda.is_available() else "cpu")
        except Exception:   # noqa: BLE001 — a scrape must never fail
            detected = "unknown"
        _BUILD_INFO_MEMO = (torch.__version__, detected)
    torch_version, detected = _BUILD_INFO_MEMO
    chip = os.environ.get("PT_COST_CHIP", "").strip() or detected
    return {"torch": torch_version, "chip": chip, "knobs": "",
            "calibration": ""}


def render_prometheus(snapshot: dict) -> str:
    """Render a merged metrics snapshot (ServingMetrics.snapshot() /
    global_snapshot()) as Prometheus text exposition (version 0.0.4).
    None values are omitted — absence is the Prometheus idiom for 'no
    observation yet', not 0."""
    lines: List[str] = []
    typed: set = set()

    def esc(v) -> str:
        # the 0.0.4 format requires \ " and newline escaped in label
        # values; names are caller-controlled strings
        return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    def emit(metric: str, labels: Dict[str, str], value,
             kind: str = "gauge") -> None:
        if value is None:
            return
        if metric not in typed:
            typed.add(metric)
            lines.append(f"# TYPE {metric} {kind}")
        lab = ",".join(f'{k}="{esc(v)}"' for k, v in labels.items())
        # full precision: %g's 6 significant digits would freeze large
        # counters between scrapes, breaking rate() on the very
        # throughput series this exposition exists for. repr = shortest
        # round-trip form.
        val = float(value)
        text = str(int(val)) if val.is_integer() else repr(val)
        lines.append(f"{metric}{{{lab}}} {text}")

    def serve_labels(name: str, snap: dict) -> Dict[str, str]:
        # the model label comes from the snapshot itself (the merge key
        # may be namespaced, e.g. the fleet's "r0/ranker"), and a
        # replica id — stamped by ServingMetrics(replica=...) in
        # multi-engine processes — becomes a label so two replicas
        # serving one model name are distinct series, not duplicates
        labels = {"model": str(snap.get("model", name))}
        if snap.get("replica"):
            labels["replica"] = str(snap["replica"])
        return labels

    # identity first: one constant-1 info series whose labels say what
    # produced every number below — torch version, chip, armed knobs
    emit("pt_build_info", build_info_labels(), 1)
    for name, snap in sorted(snapshot.get("models", {}).items()):
        base = serve_labels(name, snap)
        for key in _SERVE_COUNTERS:
            emit(f"pt_serve_{key}_total", base, snap.get(key),
                 "counter")
        for key in _SERVE_GAUGES:
            emit(f"pt_serve_{key}", base, snap.get(key))
        for phase, pcts in snap.get("latency", {}).items():
            for q in ("p50", "p95", "p99"):
                emit("pt_serve_latency_ms",
                     dict(base, phase=phase, quantile=q),
                     pcts.get(f"{q}_ms"))
        for key, val in snap.get("phases", {}).items():
            if key.endswith("_s"):
                emit("pt_serve_phase_seconds_total",
                     dict(base, phase=key[:-2]), val, "counter")
    for name, snap in sorted(snapshot.get("decode", {}).items()):
        base = serve_labels(name, snap)
        for key in _DECODE_COUNTERS:
            emit(f"pt_decode_{key}_total", base, snap.get(key),
                 "counter")
        for key in _DECODE_GAUGES:
            emit(f"pt_decode_{key}", base, snap.get(key))
        for key in _KV_COUNTERS + _SPEC_COUNTERS:
            emit(f"pt_{key}_total", base, snap.get(key), "counter")
        for key in _KV_GAUGES + _SPEC_GAUGES:
            emit(f"pt_{key}", base, snap.get(key))
        for key in ("prefill_s", "decode_s"):
            emit("pt_decode_phase_seconds_total",
                 dict(base, phase=key[:-2]), snap.get(key),
                 "counter")
    for name, snap in sorted(snapshot.get("fleet", {}).items()):
        # the replica-tier family (serving/fleet/): pool size +
        # per-replica health gauges, dispatch/shed/scale counters
        fl = {"fleet": str(snap.get("name", name))}
        emit("pt_fleet_replicas", fl, snap.get("replicas"))
        for key in ("completed", "failed", "failovers", "rebuilds"):
            emit(f"pt_fleet_{key}_total", fl, snap.get(key), "counter")
        for policy, n in sorted((snap.get("dispatched") or {}).items()):
            emit("pt_fleet_dispatch_total", dict(fl, policy=policy), n,
                 "counter")
        for cls, n in sorted((snap.get("sheds") or {}).items()):
            emit("pt_fleet_sheds_total",
                 dict(fl, **{"class": str(cls), "kind": "overload"}), n,
                 "counter")
        for cls, n in sorted((snap.get("sheds_deadline") or {}).items()):
            emit("pt_fleet_sheds_total",
                 dict(fl, **{"class": str(cls), "kind": "deadline"}), n,
                 "counter")
        for direction, n in sorted(
                (snap.get("scale_events") or {}).items()):
            emit("pt_fleet_scale_events_total",
                 dict(fl, direction=direction), n, "counter")
        for cls, n in sorted((snap.get("queue_depths") or {}).items()):
            emit("pt_fleet_queue_depth",
                 dict(fl, **{"class": str(cls)}), n)
        for rid, h in sorted((snap.get("replica_health") or {}).items()):
            rl = dict(fl, replica=str(rid))
            emit("pt_fleet_replica_queue_depth", rl,
                 h.get("queue_depth"))
            emit("pt_fleet_replica_ewma_ms", rl, h.get("ewma_ms"))
            emit("pt_fleet_replica_healthy", rl,
                 1 if h.get("healthy") else 0)
    for name, snap in sorted(snapshot.get("data", {}).items()):
        for key in _DATA_COUNTERS:
            emit(f"pt_data_{key}_total", {"pipeline": name},
                 snap.get(key), "counter")
        for key in _DATA_GAUGES:
            emit(f"pt_data_{key}", {"pipeline": name}, snap.get(key))
        for stage, st in snap.get("stages", {}).items():
            emit("pt_data_stage_seconds_total",
                 {"pipeline": name, "stage": stage}, st.get("busy_s"),
                 "counter")
            emit("pt_data_stage_occupancy",
                 {"pipeline": name, "stage": stage}, st.get("occupancy"))
    for name, snap in sorted(snapshot.get("train", {}).items()):
        for key in _TRAIN_COUNTERS:
            emit(f"pt_train_{key}_total", {"trainer": name},
                 snap.get(key), "counter")
        for key in _TRAIN_GAUGES:
            emit(f"pt_train_{key}", {"trainer": name}, snap.get(key))
        for q, val in (snap.get("step_time") or {}).items():
            emit("pt_train_step_time_ms",
                 {"trainer": name, "quantile": q[:-3]}, val)
    for name, snap in sorted(snapshot.get("model", {}).items()):
        for key in _MODEL_GAUGES:
            emit(f"pt_model_{key}", {"program": name}, snap.get(key))
        emit("pt_model_steps_total", {"program": name},
             snap.get("steps"), "counter")
        if snap.get("bound") is not None:
            # declared roofline bound as an info-style series: the label
            # carries the enum, the value is a constant 1
            emit("pt_model_bound",
                 {"program": name, "bound": snap["bound"]}, 1)
    for name, snap in sorted(snapshot.get("op", {}).items()):
        # per-op attribution (obs/opprof.py): the coverage gauge says
        # how much of the profiled step is attributed to cost-model-
        # covered ops; the top-K laggards ride as labeled rows
        for key in _OP_GAUGES:
            emit(f"pt_op_{key}", {"program": name}, snap.get(key))
        for row in snap.get("top_ops") or []:
            labels = {"program": name, "op": str(row.get("name")),
                      "type": str(row.get("type"))}
            for key in _OP_ROW_GAUGES:
                emit(f"pt_op_{key}", labels, row.get(key))
    for name, snap in sorted(snapshot.get("calib", {}).items()):
        # the calibration loop (analysis/calibrate.py + the Trainer's
        # drift-triggered re-plan): closure count, the current sustain
        # streak against the armed threshold, and the calibration
        # identity in play as an info-style series
        cl = {"trainer": str(name)}
        emit("pt_calib_replans_total", cl, snap.get("replans"), "counter")
        for key in ("drift_streak", "threshold", "last_drift_ratio"):
            emit(f"pt_calib_{key}", cl, snap.get(key))
        if snap.get("calibration_version"):
            emit("pt_calib_info",
                 dict(cl, version=str(snap["calibration_version"])), 1)
    for name, snap in sorted(snapshot.get("elastic", {}).items()):
        # the elastic supervisor (resilience/elastic.py): restart /
        # reshard counters, accumulated downtime, and the degraded-mode
        # chip gauges (current vs the fleet the run was launched for)
        el = {"supervisor": str(snap.get("name", name))}
        for key in ("restarts", "reshards"):
            emit(f"pt_elastic_{key}_total", el, snap.get(key), "counter")
        emit("pt_elastic_downtime_seconds_total", el,
             snap.get("downtime_s"), "counter")
        for key in ("current_chips", "target_chips"):
            emit(f"pt_elastic_{key}", el, snap.get(key))
        for site, n in sorted((snap.get("restarts_by_site") or {}).items()):
            emit("pt_elastic_restart_site_total", dict(el, site=str(site)),
                 n, "counter")
    for name, snap in sorted(snapshot.get("orch", {}).items()):
        # the host-level orchestrator (resilience/orchestrator.py):
        # live-worker and lease-age gauges, evictions split by recorded
        # cause (worker_crash vs heartbeat_loss — dead vs hung), and the
        # recovery clock (evict -> survivors beating on the new round)
        ol = {"orchestrator": str(snap.get("name", name))}
        for key in ("workers_live", "workers_total", "rounds",
                    "current_chips", "target_chips"):
            emit(f"pt_orch_{key}", ol, snap.get(key))
        emit("pt_orch_lease_age_seconds", ol, snap.get("lease_age_max_s"))
        emit("pt_orch_detect_seconds", ol, snap.get("last_detect_s"))
        emit("pt_orch_last_recovery_seconds", ol,
             snap.get("last_recovery_s"))
        emit("pt_orch_recoveries_total", ol, snap.get("recoveries"),
             "counter")
        emit("pt_orch_recovery_seconds_total", ol,
             snap.get("recovery_s_total"), "counter")
        for cause, n in sorted((snap.get("evictions_by_cause") or {})
                               .items()):
            emit("pt_orch_evictions_total", dict(ol, cause=str(cause)),
                 n, "counter")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# exposition conformance (the CI `obs` leg's check)
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_LABEL_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\\n]|\\\\|\\"|\\n)*)"')


def validate_exposition(text: str) -> List[str]:
    """Check Prometheus text-format (0.0.4) conformance: every sample
    line parses (`name{labels} value`), every metric has a `# TYPE`
    line BEFORE its first sample, label values are correctly escaped,
    no duplicate series. Returns problems (empty = conformant)."""
    problems: List[str] = []
    typed: set = set()
    seen_series: set = set()
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                if parts[3] not in ("counter", "gauge", "histogram",
                                    "summary", "untyped"):
                    problems.append(f"line {i}: unknown TYPE {parts[3]!r}")
                if parts[2] in typed:
                    problems.append(
                        f"line {i}: duplicate TYPE for {parts[2]!r}")
                typed.add(parts[2])
            continue
        m = _NAME_RE.match(line)
        if m is None:
            problems.append(f"line {i}: unparsable sample {line!r}")
            continue
        name = m.group(0)
        rest = line[m.end():]
        labels = ""
        if rest.startswith("{"):
            close = rest.find("}")
            if close < 0:
                problems.append(f"line {i}: unterminated label set")
                continue
            labels = rest[1:close]
            rest = rest[close + 1:]
            consumed = _LABEL_RE.sub("", labels).replace(",", "").strip()
            if consumed:
                problems.append(
                    f"line {i}: malformed/unescaped labels {labels!r}")
        value = rest.strip().split()[0] if rest.strip() else ""
        try:
            float(value)
        except ValueError:
            problems.append(f"line {i}: non-numeric value {value!r}")
        if name not in typed:
            problems.append(
                f"line {i}: sample for {name!r} has no preceding # TYPE")
        series = (name, tuple(sorted(_LABEL_RE.findall(labels))))
        if series in seen_series:
            problems.append(f"line {i}: duplicate series {name}"
                            f"{{{labels}}}")
        seen_series.add(series)
    return problems

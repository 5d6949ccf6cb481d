"""Telemetry: span tracing, metrics, per-request serving timelines.

Counterpart of ``repro/telemetry/`` for the PyTorch port: the same facade,
records and export formats (`scripts/check_trace.py` validates either
package's export). It adds no device sync: spans and stamps read the host
clock where the code already is, so a span times device work only where
the work inside it ends in a tensor read to the host (README: which spans
do).

The `Telemetry` facade bundles the three layers (docs/observability.md):

* a ring-buffer span `Tracer` with Chrome-trace/Perfetto JSON export,
* a `MetricsRegistry` (counters / gauges / fixed-bucket histograms) with
  Prometheus-text and JSONL export,
* `ServingTimelines` — per-request lifecycle stamps folded into
  per-priority SLO histograms (queue wait, TTFT, TPOT, deadline slack),

plus a free-form JSONL record stream (`record`) for one-shot structured
facts: trainer step metrics, `cost.plan_attribution` dumps, run config.

One `Telemetry` can span several scheduler runs (a warm benchmark reruns
`serve()` with the same engine): each `Scheduler` gets a FRESH timelines
object + metrics registry via `new_timelines()` / `adopt_registry()`, so
request ids and counters never collide across runs; the facade stitches
every run back together at export time (one Perfetto process per run).

Disabled contract: `Telemetry(enabled=False)` — and the module-level
`NULL_TELEMETRY` singleton — makes every hot-path call a no-op without
call sites branching: `span()` returns the null span, `new_timelines()`
returns the shared `NULL_TIMELINES`, `record()` returns immediately.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from .cost import (causal_attention_flops, chunk_prefill_flops,
                   decode_token_flops, exact_attention_flops,
                   plan_attribution)
from .metrics import (MS_BUCKETS, TICK_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry, percentile_from_cumulative)
from .trace import HOST_PID, Tracer, write_chrome_trace
from .timeline import NULL_TIMELINES, NullTimelines, ServingTimelines

# pid block for synthesized per-request run tracks (HOST_PID=0 is the
# host spans/instants track)
RUN_PID_BASE = 100


class Telemetry:
    """Facade over tracer + metrics + timelines + JSONL records."""

    def __init__(self, enabled: bool = True, trace_capacity: int = 1 << 16):
        self.enabled = enabled
        self.tracer = Tracer(enabled=enabled, capacity=trace_capacity)
        self.metrics = MetricsRegistry()
        self.records: List[Dict] = []
        self._runs: List[Dict] = []        # {label, timelines?, registry?}

    # -- hot-path surface (all no-ops when disabled) -----------------------

    def span(self, name: str, cat: str = "span", **args):
        return self.tracer.span(name, cat, **args)

    def instant(self, name: str, cat: str = "event", **args) -> None:
        self.tracer.instant(name, cat, **args)

    def record(self, kind: str, **fields) -> None:
        """Append one structured JSONL record (e.g. a train step)."""
        if not self.enabled:
            return
        self.records.append({"kind": kind, **fields})

    # -- per-run attachments ----------------------------------------------

    def new_timelines(self, label: str = "serving"):
        """A fresh per-request timeline namespace for one scheduler run."""
        if not self.enabled:
            return NULL_TIMELINES
        tl = ServingTimelines(self.tracer)
        self._runs.append({"label": f"{label}#{len(self._runs)}",
                           "timelines": tl})
        return tl

    def adopt_registry(self, registry: MetricsRegistry,
                       label: str = "serving") -> None:
        """Adopt a run-local registry (a Scheduler's ScheduleStats backing
        store) so its counters/histograms land in this facade's exports."""
        if not self.enabled:
            return
        for run in reversed(self._runs):
            if run["label"].startswith(label) and "registry" not in run:
                run["registry"] = registry
                return
        self._runs.append({"label": f"{label}#{len(self._runs)}",
                           "registry": registry})

    # -- export ------------------------------------------------------------

    def chrome_events(self) -> List[Dict]:
        events = self.tracer.chrome_events()
        events.append({"ph": "M", "name": "process_name", "pid": HOST_PID,
                       "args": {"name": "host"}})
        for i, run in enumerate(self._runs):
            tl = run.get("timelines")
            if tl is not None:
                events.extend(tl.trace_events(pid=RUN_PID_BASE + i,
                                              run_label=run["label"]))
        return events

    def export_trace(self, path: str,
                     metadata: Optional[Dict] = None) -> str:
        meta = {"dropped_events": self.tracer.dropped}
        if metadata:
            meta.update(metadata)
        return write_chrome_trace(path, self.chrome_events(), metadata=meta)

    def metrics_records(self) -> List[Dict]:
        """All JSONL records: free-form `record()` entries, the facade
        registry, and every adopted per-run registry (tagged with its run
        label)."""
        out = list(self.records)
        out.extend(self.metrics.jsonl_records())
        for run in self._runs:
            reg = run.get("registry")
            if reg is not None:
                for rec in reg.jsonl_records():
                    rec["run"] = run["label"]
                    out.append(rec)
        return out

    def export_metrics_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for rec in self.metrics_records():
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        return path

    def prometheus_text(self) -> str:
        parts = [self.metrics.prometheus_text()]
        for run in self._runs:
            reg = run.get("registry")
            if reg is not None:
                parts.append(f"# run: {run['label']}\n"
                             + reg.prometheus_text())
        return "".join(p for p in parts if p)


NULL_TELEMETRY = Telemetry(enabled=False)


def as_telemetry(telemetry: Optional[Telemetry]) -> Telemetry:
    """None -> the shared disabled singleton (zero-overhead call sites)."""
    return telemetry if telemetry is not None else NULL_TELEMETRY


__all__ = [
    "Counter", "Gauge", "Histogram", "HOST_PID", "MetricsRegistry",
    "MS_BUCKETS", "NULL_TELEMETRY", "NULL_TIMELINES", "NullTimelines",
    "RUN_PID_BASE", "ServingTimelines", "Telemetry", "Tracer", "TICK_BUCKETS",
    "as_telemetry", "causal_attention_flops", "chunk_prefill_flops",
    "decode_token_flops", "exact_attention_flops",
    "percentile_from_cumulative", "plan_attribution", "write_chrome_trace",
]

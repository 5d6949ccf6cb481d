"""Metrics registry: counters, gauges, fixed-bucket histograms, with
Prometheus-style text and JSONL export.

Counterpart of ``repro/telemetry/metrics.py``, line for line (plain Python,
no tensor): the same names, buckets, percentiles and export formats, so a
port run's dump reads exactly like the JAX package's.

Design constraints (docs/observability.md §Metric name registry):

* **Label-aware** — a metric is keyed by (name, sorted label items), so
  ``reg.counter("serving_sheds_total", reason="queue_full")`` and the
  ``reason="deadline_infeasible"`` variant are distinct series, exactly
  like Prometheus.
* **Fixed buckets** — histograms take their bucket boundaries at creation
  and never rebucket; observation is O(log n_buckets) with zero
  allocation. Percentiles are reconstructed by linear interpolation
  within the hit bucket (the standard Prometheus ``histogram_quantile``
  approximation), so a percentile is as accurate as the bucket grid —
  good enough for SLO attribution, never a replacement for a raw trace.
* **Plain objects** — `Counter.value` is a float attribute; incrementing
  one is an attribute add, cheap enough for per-chunk host-side counting.
  `serving/scheduler.ScheduleStats` is a *view* over these counters, not
  a parallel set of hand-rolled ints.
"""
from __future__ import annotations

import bisect
import json
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Default grids: virtual-time (scheduler ticks) and host milliseconds.
TICK_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, math.inf)
MS_BUCKETS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
              math.inf)


class Counter:
    """Monotonic-by-convention float counter. `value` is directly
    assignable so stat *views* (ScheduleStats) can restore/overwrite."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram: cumulative-export compatible counts plus
    sum/count/min/max."""

    __slots__ = ("buckets", "counts", "sum", "count", "min", "max")

    def __init__(self, buckets: Sequence[float]):
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        if bs[-1] != math.inf:
            bs = bs + (math.inf,)
        self.buckets = bs
        self.counts = [0] * len(bs)         # per-bucket (NOT cumulative)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le, cumulative_count)] — the Prometheus export shape."""
        out, acc = [], 0
        for le, c in zip(self.buckets, self.counts):
            acc += c
            out.append((le, acc))
        return out

    def percentile(self, p: float) -> float:
        """Approximate p∈[0,100] percentile by linear interpolation inside
        the hit bucket (clamped to observed min/max so a sparse histogram
        cannot report a value outside its data)."""
        return percentile_from_cumulative(self.cumulative(), self.count, p,
                                          lo=self.min, hi=self.max)


def percentile_from_cumulative(cumulative: Sequence[Tuple[float, int]],
                               total: int, p: float,
                               lo: float = math.inf,
                               hi: float = -math.inf) -> float:
    """Shared percentile reconstruction — also used by benchmarks/report.py
    on a metrics *JSONL dump*, where only the cumulative counts survive."""
    if total <= 0:
        return float("nan")
    rank = (p / 100.0) * total
    prev_le, prev_cum = 0.0, 0
    for le, cum in cumulative:
        if cum >= rank:
            in_bucket = cum - prev_cum
            frac = 1.0 if in_bucket == 0 else (rank - prev_cum) / in_bucket
            upper = hi if le == math.inf and hi > -math.inf else le
            val = prev_le + frac * (upper - prev_le)
            if lo != math.inf:
                val = max(val, lo)
            if hi != -math.inf:
                val = min(val, hi)
            return val
        prev_le, prev_cum = le, cum
    return hi if hi > -math.inf else float("nan")


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


class MetricsRegistry:
    """Create-on-first-use registry of labelled counters/gauges/histograms."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple], object] = {}
        self._types: Dict[str, str] = {}    # name -> counter|gauge|histogram

    def _get(self, kind: str, name: str, labels: Dict[str, str], factory):
        prev = self._types.setdefault(name, kind)
        if prev != kind:
            raise ValueError(f"metric {name!r} already registered as {prev}")
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = factory()
            self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(buckets or MS_BUCKETS))

    def items(self) -> Iterable[Tuple[str, Dict[str, str], object]]:
        for (name, labels), m in sorted(self._metrics.items(),
                                        key=lambda kv: kv[0]):
            yield name, dict(labels), m

    # -- export ------------------------------------------------------------

    def prometheus_text(self) -> str:
        """Prometheus exposition format (one # TYPE line per family)."""
        lines: List[str] = []
        seen_type = set()
        for name, labels, m in self.items():
            kind = self._types[name]
            if name not in seen_type:
                lines.append(f"# TYPE {name} {kind}")
                seen_type.add(name)
            ls = _label_str(_label_key(labels))
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"{name}{ls} {m.value:g}")
            else:
                for le, cum in m.cumulative():
                    le_s = "+Inf" if le == math.inf else f"{le:g}"
                    il = _label_key({**labels, "le": le_s})
                    lines.append(f"{name}_bucket{_label_str(il)} {cum}")
                lines.append(f"{name}_sum{ls} {m.sum:g}")
                lines.append(f"{name}_count{ls} {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def jsonl_records(self) -> List[Dict]:
        """One JSON-serializable dict per metric series (the JSONL dump
        schema of docs/observability.md §JSONL export)."""
        out = []
        for name, labels, m in self.items():
            rec: Dict = {"metric": name, "type": self._types[name],
                         "labels": labels}
            if isinstance(m, (Counter, Gauge)):
                rec["value"] = m.value
            else:
                rec["buckets"] = [["+Inf" if le == math.inf else le, cum]
                                  for le, cum in m.cumulative()]
                rec["sum"] = m.sum
                rec["count"] = m.count
                if m.count:
                    rec["min"] = m.min
                    rec["max"] = m.max
                    rec["p50"] = m.percentile(50)
                    rec["p90"] = m.percentile(90)
                    rec["p99"] = m.percentile(99)
            out.append(rec)
        return out

    def jsonl_text(self) -> str:
        return "".join(json.dumps(r, sort_keys=True) + "\n"
                       for r in self.jsonl_records())

"""Ring-buffer span tracer with Chrome-trace-event / Perfetto JSON export.

Counterpart of ``repro/telemetry/trace.py``, line for line. A span times
the host: on the card, CUDA runs ahead of it, so a span measures device
work only where the code inside it waits for the device (a tensor read to
the host); otherwise it measures the dispatch, and the next sync takes the
device time. Telemetry adds no sync of its own.

Contract (docs/observability.md §Overhead contract):

* **Monotonic clock** — timestamps come from ``time.perf_counter_ns``
  (never wall-clock), taken once on span entry and once on exit. All
  exported timestamps are microseconds relative to the tracer's birth.
* **Bounded memory** — events land in a fixed-capacity ring buffer; once
  full, the oldest event is overwritten and ``dropped`` counts how many
  were lost (the export records the drop count, so a truncated trace can
  never silently masquerade as a complete one).
* **Thread-safe** — the ring push takes a lock; spans themselves carry no
  shared state, so concurrently open spans from different threads are
  fine. The exported events carry the OS thread id, so Perfetto renders
  one track per thread.
* **Disabled = no-op** — a disabled tracer's ``span()`` returns a single
  module-level ``_NULL_SPAN`` object (no allocation, no clock read, no
  lock) and ``instant()`` returns immediately. The decode hot path can
  therefore keep its instrumentation calls unconditionally; with
  telemetry off they cost one attribute load and one branch
  (negative-tested in tests/test_torch_telemetry.py).

Export is the Chrome trace-event JSON array format (``{"traceEvents":
[...]}``) that both ``chrome://tracing`` and https://ui.perfetto.dev load
directly: ``"X"`` (complete) events for spans, ``"i"`` (instant) events
for point markers, ``"M"`` metadata records for track names.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional

HOST_PID = 0            # pid of the host-side scheduler/engine/trainer track


class _NullSpan:
    """The disabled-tracer span: a process-wide singleton whose context
    protocol does nothing. `annotate` swallows late args the same way."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **args):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """An open span: records [enter, exit) as one complete event."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = self._tracer._now_us()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer._now_us()
        self._tracer._push(("X", self._name, self._cat, self._t0,
                            t1 - self._t0, threading.get_ident(),
                            self._args or None))
        return False

    def annotate(self, **args):
        """Attach (or override) args after entry — e.g. a row count only
        known once the work inside the span finished."""
        if self._args is None:
            self._args = {}
        self._args.update(args)
        return self


class Tracer:
    """Low-overhead span/instant recorder. See the module docstring for
    the clock/memory/threading/disabled contract."""

    def __init__(self, enabled: bool = True, capacity: int = 1 << 16,
                 clock: Callable[[], int] = time.perf_counter_ns):
        self.enabled = enabled
        self.capacity = int(capacity)
        self.dropped = 0
        self._clock = clock
        self._lock = threading.Lock()
        self._events: List[tuple] = []
        self._next = 0                      # overwrite cursor once full
        self._t0_ns = clock() if enabled else 0

    # -- recording ---------------------------------------------------------

    def _now_us(self) -> float:
        return (self._clock() - self._t0_ns) / 1e3

    def _push(self, ev: tuple) -> None:
        with self._lock:
            if len(self._events) < self.capacity:
                self._events.append(ev)
            else:
                self._events[self._next] = ev
                self._next = (self._next + 1) % self.capacity
                self.dropped += 1

    def span(self, name: str, cat: str = "span", **args):
        """Context manager timing a host-side region. Disabled tracers
        return the no-op singleton — zero allocation on the hot path."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "event", **args) -> None:
        """A point-in-time marker (rendered as an arrow/flag in Perfetto)."""
        if not self.enabled:
            return
        self._push(("i", name, cat, self._now_us(), 0,
                    threading.get_ident(), args or None))

    # -- export ------------------------------------------------------------

    def events(self) -> List[tuple]:
        """Recorded events, oldest first (unwrapping the ring)."""
        with self._lock:
            if len(self._events) < self.capacity:
                return list(self._events)
            return self._events[self._next:] + self._events[:self._next]

    def chrome_events(self) -> List[Dict]:
        """Events as Chrome trace-event dicts (host pid, per-thread tids)."""
        out = []
        for ph, name, cat, ts, dur, tid, args in self.events():
            ev = {"ph": ph, "name": name, "cat": cat, "ts": round(ts, 3),
                  "pid": HOST_PID, "tid": tid}
            if ph == "X":
                ev["dur"] = round(dur, 3)
            if ph == "i":
                ev["s"] = "t"               # thread-scoped instant
            if args:
                ev["args"] = args
            out.append(ev)
        return out


def write_chrome_trace(path: str, events: List[Dict],
                       metadata: Optional[Dict] = None) -> str:
    """Write a Chrome-trace/Perfetto JSON object file. `events` are
    trace-event dicts (from `Tracer.chrome_events` plus any synthesized
    track events); `metadata` lands under the top-level "metadata" key."""
    payload = {
        "traceEvents": sorted(events, key=lambda e: e.get("ts", 0.0)),
        "displayTimeUnit": "ms",
    }
    if metadata:
        payload["metadata"] = metadata
    with open(path, "w") as f:
        json.dump(payload, f)
        f.write("\n")
    return path

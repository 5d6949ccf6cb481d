"""Per-request serving lifecycle timelines.

Counterpart of ``repro/telemetry/timeline.py``, line for line.

Every request admitted to the continuous-batching scheduler moves through
a small state machine (docs/serving.md):

    queued -> admitted -> prefilling (per chunk) -> decoding (per chunk)
           -> preempted/snapshotted -> requeued -> ... -> retired
           |  shed (queue_full | deadline_infeasible | retries_exhausted)
           |  quarantined (fault)

`ServingTimelines.stamp()` records each transition **at the existing
per-chunk host sync** — the scheduler already returns to Python between
decode chunks, so stamping there adds zero device syncs (negative-tested
in tests/test_torch_telemetry.py by comparing chunk counts with telemetry on
and off).

From the raw stamps, `finalize()` derives the serving SLO histograms —
queue wait, TTFT (time to first token), TPOT (time per output token),
deadline slack — each labelled by priority class, plus
deadline-miss-attribution counters, and writes them into a
`MetricsRegistry`.

`trace_events()` synthesizes one Perfetto track *per request* (a distinct
tid under a per-run pid), with phase bars (queued / prefilling /
decoding / requeued) and instant markers for point events (snapshot,
shed, deadline_miss, ...), so a request's whole life is one horizontal
lane in the UI.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .metrics import MetricsRegistry, TICK_BUCKETS, MS_BUCKETS

# Events that OPEN a phase bar (value = bar name), and events that CLOSE
# whatever bar is open. Everything stamped also gets an instant marker.
_PHASE_STARTS = {
    "queued": "queued",
    "admitted": "prefilling",
    "restored": "decoding",
    "first_token": "decoding",
    "preempted": "requeued",
}
_PHASE_ENDS = frozenset({"retired", "shed", "quarantined"})


class NullTimelines:
    """Disabled-telemetry stand-in: `stamp` is a no-op, `finalize` too.
    Shares the scheduler-facing surface so call sites stay unconditional."""

    __slots__ = ()
    enabled = False

    def stamp(self, rid, event, tick, **fields):
        pass

    def finalize(self, registry=None):
        pass


NULL_TIMELINES = NullTimelines()


class ServingTimelines:
    """Raw per-request stamp log + derived SLO metrics + Perfetto tracks.

    One instance covers one scheduler run; the `Telemetry` facade hands a
    fresh one to each `Scheduler` (warm benchmark reruns reuse request
    ids, so runs must not share a timeline namespace).
    """

    enabled = True

    def __init__(self, tracer=None):
        self._tracer = tracer
        # rid -> [(event, tick, t_us, fields)]
        self._stamps: Dict[int, List[Tuple[str, int, Optional[float], Dict]]] = {}

    # -- recording ---------------------------------------------------------

    def stamp(self, rid: int, event: str, tick: int, **fields) -> None:
        t_us = None
        if self._tracer is not None and self._tracer.enabled:
            t_us = self._tracer._now_us()
            self._tracer.instant(f"request_{event}", cat="request",
                                 rid=rid, tick=tick, **fields)
        self._stamps.setdefault(rid, []).append((event, tick, t_us, fields))

    def stamps(self, rid: int) -> List[Tuple[str, int, Optional[float], Dict]]:
        return list(self._stamps.get(rid, ()))

    def rids(self) -> List[int]:
        return sorted(self._stamps)

    # -- derived metrics ---------------------------------------------------

    def _first(self, rid: int, event: str):
        for s in self._stamps.get(rid, ()):
            if s[0] == event:
                return s
        return None

    def _last(self, rid: int, event: str):
        hit = None
        for s in self._stamps.get(rid, ()):
            if s[0] == event:
                hit = s
        return hit

    def finalize(self, registry: MetricsRegistry) -> None:
        """Fold raw stamps into per-priority SLO histograms and counters."""
        for rid in self.rids():
            queued = self._first(rid, "queued")
            if queued is None:
                continue
            pri = str(queued[3].get("priority", 0))
            deadline = queued[3].get("deadline")

            admitted = self._first(rid, "admitted")
            if admitted is not None:
                registry.histogram("serving_queue_wait_ticks",
                                   buckets=TICK_BUCKETS, priority=pri) \
                        .observe(admitted[1] - queued[1])

            first_tok = self._first(rid, "first_token")
            if first_tok is not None:
                registry.histogram("serving_ttft_ticks",
                                   buckets=TICK_BUCKETS, priority=pri) \
                        .observe(first_tok[1] - queued[1])
                if first_tok[2] is not None and queued[2] is not None:
                    registry.histogram("serving_ttft_ms",
                                       buckets=MS_BUCKETS, priority=pri) \
                            .observe((first_tok[2] - queued[2]) / 1e3)

            retired = self._last(rid, "retired")
            if retired is not None:
                n_tok = int(retired[3].get("n_tokens", 0))
                if (first_tok is not None and n_tok > 1
                        and retired[2] is not None
                        and first_tok[2] is not None):
                    tpot = (retired[2] - first_tok[2]) / 1e3 / (n_tok - 1)
                    registry.histogram("serving_tpot_ms",
                                       buckets=MS_BUCKETS, priority=pri) \
                            .observe(tpot)
                if deadline is not None:
                    slack = deadline - retired[1]
                    registry.histogram("serving_deadline_slack_ticks",
                                       buckets=TICK_BUCKETS, priority=pri) \
                            .observe(max(slack, 0))
                    if slack < 0:
                        registry.counter("serving_deadline_miss_total",
                                         priority=pri).inc()

            for ev, _tick, _t, fields in self._stamps[rid]:
                if ev == "shed":
                    registry.counter("serving_shed_events_total",
                                     reason=str(fields.get("reason", "?")),
                                     priority=pri).inc()
                elif ev == "preempted":
                    registry.counter("serving_preempted_events_total",
                                     priority=pri).inc()
                elif ev == "quarantined":
                    registry.counter("serving_quarantined_events_total",
                                     priority=pri).inc()

    # -- Perfetto tracks ---------------------------------------------------

    def trace_events(self, pid: int = 100, run_label: str = "serving") -> List[Dict]:
        """One lane per request: phase bars + instant markers. Requires the
        tracer to have been enabled during the run (stamps carry t_us)."""
        out: List[Dict] = []
        out.append({"ph": "M", "name": "process_name", "pid": pid,
                    "args": {"name": f"{run_label} requests"}})
        for rid in self.rids():
            stamps = [s for s in self._stamps[rid] if s[2] is not None]
            if not stamps:
                continue
            queued = self._first(rid, "queued")
            pri = queued[3].get("priority", 0) if queued else 0
            tid = rid
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid,
                        "args": {"name": f"req {rid} (pri {pri})"}})
            open_phase: Optional[Tuple[str, float]] = None
            for ev, tick, t_us, fields in stamps:
                start = _PHASE_STARTS.get(ev)
                if start is not None or ev in _PHASE_ENDS:
                    if open_phase is not None:
                        name, t0 = open_phase
                        out.append({"ph": "X", "name": name, "cat": "request",
                                    "ts": round(t0, 3),
                                    "dur": round(max(t_us - t0, 0.0), 3),
                                    "pid": pid, "tid": tid})
                        open_phase = None
                    if start is not None:
                        open_phase = (start, t_us)
                args = {"rid": rid, "tick": tick}
                args.update(fields)
                out.append({"ph": "i", "name": ev, "cat": "request",
                            "ts": round(t_us, 3), "pid": pid, "tid": tid,
                            "s": "t", "args": args})
            if open_phase is not None:
                name, t0 = open_phase
                last_t = stamps[-1][2]
                out.append({"ph": "X", "name": name, "cat": "request",
                            "ts": round(t0, 3),
                            "dur": round(max(last_t - t0, 0.0), 3),
                            "pid": pid, "tid": tid})
        return out

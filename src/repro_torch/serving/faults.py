"""Deterministic fault injection for the serving stack.

Counterpart of ``repro/serving/faults.py``, with the same seeded draws in
the same order: a random schedule of a given seed fires the same `Fault`s
on the same rows in both packages for the same serve trace. Three failure
classes, all applied at chunk boundaries through the `SlotPool` owner:

* ``slot_step``: one slot's decode step "fails" (a device fault). The
  row's cache leaves are garbled with finite noise before the chunk, and
  the injector reports the row as failed at the chunk's host sync. With
  ``detectable=False`` the report is silenced and the run streams wrong
  tokens, so recovery is negative-testable.
* ``nan_logits``: the row's cache leaves are poisoned with NaN before the
  chunk, so its logits go non-finite and the scheduler's NaN guard must
  catch it. The injector does not report this row.
* ``snapshot_corrupt``: the row's last good snapshot has one byte flipped
  after capture AND the row's step fails (as ``slot_step``), forcing a
  restore whose checksum mismatch must be detected, so recovery falls back
  to re-running the request from its prompt.

Schedules are explicit (``Fault(kind, chunk, row)``) or random:
``FaultInjector(seed=s, n_random=k)`` draws k (chunk, kind) pairs up front
and picks a live row at fire time. ``fired`` / ``skipped`` record what
happened.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from repro_torch.serving.snapshot import leaf_bytes

SLOT_STEP = "slot_step"
NAN_LOGITS = "nan_logits"
SNAPSHOT_CORRUPT = "snapshot_corrupt"
FAULT_KINDS = (SLOT_STEP, NAN_LOGITS, SNAPSHOT_CORRUPT)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault. ``chunk`` indexes executed decode chunks
    (ScheduleStats.chunks at fire time); ``row`` is the pool row, or None
    for random schedules (a live row is drawn at fire time)."""

    kind: str
    chunk: int
    row: Optional[int] = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(choose from {FAULT_KINDS})")


class FaultInjector:
    def __init__(self, schedule: Optional[Sequence[Fault]] = None, *,
                 seed: int = 0, n_random: int = 0, horizon: int = 16,
                 kinds: Sequence[str] = FAULT_KINDS,
                 detectable: bool = True):
        """`schedule`: explicit faults; or `n_random` faults drawn over
        chunks [0, horizon) from `kinds` with `seed`. `detectable=False`
        keeps the corruption but silences the failure reports (nan_logits
        stays detectable: the NaN guard, not the injector, detects it)."""
        self.detectable = detectable
        self._rng = np.random.default_rng(seed)
        if schedule is None:
            chunks = sorted(self._rng.choice(horizon, size=n_random,
                                             replace=False)
                            if n_random <= horizon else
                            self._rng.integers(0, horizon, n_random))
            schedule = [Fault(kind=str(self._rng.choice(list(kinds))),
                              chunk=int(c)) for c in chunks]
        self.schedule: List[Fault] = list(schedule)
        self.fired: List[Fault] = []      # faults that actually landed
        self.skipped: List[Fault] = []    # target row dead at fire time
        self._reported: Set[int] = set()  # rows to report failed this chunk

    # -- scheduler hooks (called between decode chunks) -------------------

    def _due(self, chunk_idx: int) -> List[Fault]:
        return [f for f in self.schedule if f.chunk == chunk_idx]

    def before_chunk(self, pool, snapshots: Dict[int, object],
                     chunk_idx: int) -> None:
        """Apply the corruption of every fault due at this chunk. `pool` is
        the SlotPool; `snapshots` the scheduler's row -> last good
        snapshot map."""
        self._reported = set()
        for fault in self._due(chunk_idx):
            row = fault.row
            if row is None:
                live = [r for r, s in enumerate(pool.slots) if s is not None]
                if not live:
                    self.skipped.append(fault)
                    continue
                row = int(self._rng.choice(live))
            elif pool.slots[row] is None:
                self.skipped.append(fault)
                continue
            fault = dataclasses.replace(fault, row=row)
            if fault.kind == NAN_LOGITS:
                pool.corrupt_row(row, mode="nan")
            else:                          # slot_step / snapshot_corrupt
                pool.corrupt_row(row, mode="garble")
                if self.detectable:
                    self._reported.add(row)
            if fault.kind == SNAPSHOT_CORRUPT:
                snap = snapshots.get(row)
                if snap is None:
                    self.skipped.append(fault)
                    continue
                # one byte of one leaf, drawn uniformly over every leaf
                # (on a paged pool: pages, ring, counters or an fp32 scale)
                keys = sorted(snap.cache_rows)
                key = keys[int(self._rng.integers(len(keys)))]
                flat = leaf_bytes(snap.cache_rows[key])
                if flat.numel() == 0:
                    # the pages of a row with no committed block: no byte
                    # to flip (JAX's draw raises a ValueError here)
                    self.skipped.append(fault)
                    continue
                i = int(self._rng.integers(flat.numel()))
                flat[i] = flat[i] ^ 0xFF
            self.fired.append(fault)

    def failed_rows(self, chunk_idx: int) -> Set[int]:
        """Rows whose step the injector reports failed for the chunk that
        just ran (the simulated device-error status)."""
        return set(self._reported)

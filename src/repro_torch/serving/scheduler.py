"""SLO-aware slot-based continuous-batching scheduler over the
device-resident decode loop.

Counterpart of ``repro/serving/scheduler.py`` without its telemetry (the
stamps, spans, page gauges and per-priority histograms): the same
decisions on the same trace, so the same tokens, `ShedResult`s and
`ScheduleStats` counters. The counters keep JAX's attribute names.

The unit of work is a *slot*: one row of a fixed (max_batch)-row pool
cache, mutated only between decode chunks:

* **Admission**: earliest deadline first within priority classes. Arrived
  requests are ordered by (priority, deadline, submission order); lower
  `priority` is more urgent, no deadline sorts last within its class, and
  with every knob at its default the order is FCFS. With
  `engine.prefill_chunk == 0` (monolithic) an admitted request is
  prefilled alone (B=1) and copied into its row; with `prefill_chunk > 0`
  (chunked) the slot is claimed PREFILLING at t=0 and the prompt streams
  into the pool one chunk per round (`_advance_prefill`), every
  co-prefilling row sharing one padded forward.
* **Preemption**: when no slot is free, an arrived request STRICTLY more
  urgent than the least urgent occupied slot evicts it: the victim's state
  goes to a host `SlotSnapshot` (its cache rows, O(c + M) bytes, `cur`,
  `finished`, emitted tokens, prefill progress) and it is requeued; at
  re-admission the snapshot is restored and the row decodes on as if never
  interrupted. A paged pool also preempts under page pressure: a stalled
  prefill pool, or a decode chunk the arena cannot cover
  (`_ensure_decode_pages`).
* **Overload shedding**: `max_queue` bounds the queue; a submit past it
  sheds the entry EDF would run last, with an explicit `ShedResult`. Each
  round, a waiting request whose deadline even the optimistic estimate
  (`_needed_ticks`) cannot meet is shed as infeasible; on a paged pool, one
  whose prompt + budget could never fit the arena is shed up front.
* **Decode**: the pool decodes `decode_chunk` tokens on the device with ONE
  host sync per chunk, which also carries a per-row non-finite-logits flag
  (the NaN guard).
* **Faults and quarantine**: a row flagged bad, or reported failed by an
  attached `FaultInjector`, is quarantined at the chunk boundary: its
  tokens of that chunk are dropped, the row is scrubbed (zeroed), and the
  request is requeued from its last good snapshot, or from scratch.
  Retries are bounded by `max_retries`; exhaustion sheds. A snapshot whose
  checksum fails at restore falls back to from-scratch.
* **Retirement**: an EOS or an exhausted budget frees the slot; a
  completion past the request's deadline counts a `deadline_miss`.

Greedy decode of a request depends only on its own prompt (per-row masks
make every row's attention independent of its neighbours), so any mix of
preemptions, requeues and restores gives the same tokens as the static
bucketed baseline.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import EOS
from repro_torch.serving.paged import PageAllocator, pages_needed
from repro_torch.serving.snapshot import SlotSnapshot, capture

_INF = float("inf")

# ShedResult reasons
SHED_QUEUE_FULL = "queue_full"
SHED_DEADLINE_INFEASIBLE = "deadline_infeasible"
SHED_RETRIES_EXHAUSTED = "retries_exhausted"
# paged pool: the request's lifetime page need exceeds the whole arena, so
# it could never run to completion
SHED_PAGES_EXHAUSTED = "pages_exhausted"

# Slot states: a monolithically admitted slot is born DECODING; under
# chunked admission a slot is born PREFILLING and flips to DECODING when its
# first token is sampled.
PREFILLING = "prefilling"
DECODING = "decoding"


@dataclasses.dataclass
class Request:
    """One generation request.

    `arrival_chunk`: admissible once that much virtual time (executed
    chunks + idle ticks) has passed; 0 = at once. `priority`: admission
    class, LOWER is more urgent. `deadline_ticks`: absolute virtual-time
    deadline (None = none), used for EDF order, feasibility shedding and
    the deadline_misses counter."""

    rid: int
    tokens: Tuple[int, ...]
    max_new_tokens: int
    arrival_chunk: int = 0
    priority: int = 0
    deadline_ticks: Optional[int] = None

    def __post_init__(self):
        if len(self.tokens) == 0:
            raise ValueError(f"request {self.rid}: empty prompt (there are "
                             "no logits to sample a first token from)")
        if self.max_new_tokens <= 0:
            raise ValueError(f"request {self.rid}: max_new_tokens="
                             f"{self.max_new_tokens} must be positive")
        if self.arrival_chunk < 0:
            raise ValueError(f"request {self.rid}: arrival_chunk="
                             f"{self.arrival_chunk} must be >= 0")
        if self.deadline_ticks is not None and self.deadline_ticks < 0:
            raise ValueError(f"request {self.rid}: deadline_ticks="
                             f"{self.deadline_ticks} must be >= 0")


@dataclasses.dataclass(frozen=True)
class ShedResult:
    """Explicit rejection, returned in place of the token list."""

    rid: int
    reason: str        # one of the SHED_* reasons
    tick: int          # virtual time of the decision
    priority: int


@dataclasses.dataclass
class _Slot:
    request: Request
    emitted: List[int]
    state: str = DECODING
    filled: int = 0             # prompt tokens committed to the cache
    seq: int = 0                # submission order (EDF tie-break)
    retries: int = 0            # fault requeues consumed so far


@dataclasses.dataclass
class _QueueEntry:
    """A waiting request, possibly carrying resume state from a preemption
    or a fault requeue."""

    request: Request
    seq: int
    snapshot: Optional[SlotSnapshot] = None
    retries: int = 0

    def sort_key(self) -> Tuple[int, float, int]:
        """EDF within priority classes, submission order breaking ties. The
        max of this key over a set is the shedding victim."""
        dl = self.request.deadline_ticks
        return (self.request.priority, _INF if dl is None else dl, self.seq)


def _slot_sort_key(slot: _Slot) -> Tuple[int, float, int]:
    dl = slot.request.deadline_ticks
    return (slot.request.priority, _INF if dl is None else dl, slot.seq)


@dataclasses.dataclass
class ScheduleStats:
    """Scheduler counters, under the attribute names of JAX's
    ScheduleStats (which keeps them in a metrics registry)."""

    chunks: int = 0                # decode chunks executed
    idle_ticks: int = 0            # no-decode ticks (pool empty or all
    #                                prefilling)
    row_steps: int = 0             # DECODING-slot steps
    occupancy_sum: float = 0.0     # Σ per-chunk occupied fraction
    prefill_forwards: int = 0      # prefill launches (B=1, chunk, remainder)
    prefill_tokens: int = 0        # real prompt tokens prefilled
    preemptions: int = 0           # snapshot + requeue evictions
    sheds: int = 0                 # explicit ShedResults
    deadline_misses: int = 0       # late completions
    retries: int = 0               # fault requeues
    quarantines: int = 0           # faulty rows isolated
    snapshots: int = 0             # snapshots captured
    snapshot_corruptions: int = 0  # checksum failures at restore
    page_preemptions: int = 0      # evictions forced by arena-page pressure

    @property
    def ticks(self) -> int:
        """Virtual time: executed chunks + idle ticks (arrival clock)."""
        return self.chunks + self.idle_ticks

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(self.chunks, 1)

    def counters_line(self) -> str:
        """One-line SLO counter summary (logged by launch/serve.py)."""
        return (f"preemptions={self.preemptions} sheds={self.sheds} "
                f"deadline_misses={self.deadline_misses} "
                f"retries={self.retries} quarantines={self.quarantines} "
                f"snapshot_corruptions={self.snapshot_corruptions} "
                f"page_preemptions={self.page_preemptions}")


class SlotPool:
    """Sole owner of the live pool cache, the per-slot decode state and, for
    a paged pool, the page allocator. Every mutation (slot writes, chunks,
    restores, scrubs, injected corruption) goes through it; snapshot capture
    copies without mutating. Host mirrors `cur`/`finished` are uploaded at
    each chunk and refreshed at its one sync."""

    def __init__(self, engine, max_batch: int):
        self.engine = engine
        self.max_batch = max_batch
        self.cache = engine.init_pool_cache(max_batch)
        self.cur = np.full((max_batch,), EOS, np.int64)
        self.finished = np.ones((max_batch,), bool)
        self.slots: List[Optional[_Slot]] = [None] * max_batch
        self.paged: bool = engine.paged
        self.alloc: Optional[PageAllocator] = None
        self.pages_allocated = 0           # cumulative
        self.pages_freed = 0
        if self.paged:
            self.alloc = PageAllocator(engine.resolved_arena_pages(max_batch),
                                       scrub=self._scrub_freed_pages)

    def _scrub_freed_pages(self, pages) -> None:
        """PageAllocator callback: zero freed pages before their reuse."""
        self.cache = self.engine.scrub_arena_pages(self.cache, pages)
        self.pages_freed += len(pages)

    def _alloc_pages(self, row: int, n: int) -> Optional[List[int]]:
        pages = self.alloc.alloc(row, n)
        if pages is not None:
            self.pages_allocated += len(pages)
        return pages

    # -- slot table ------------------------------------------------------

    def free_rows(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def occupancy(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def decoding_count(self) -> int:
        return sum(s is not None and s.state == DECODING for s in self.slots)

    def occupied_rows(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    # -- mutations (between chunks only) ---------------------------------

    def admit(self, row: int, request: Request, slot_cache: Dict,
              first_token: int) -> None:
        """Monolithic admission: write a prefilled request (B=1 cache at the
        prompt length, first sampled token) into `row`. A paged pool
        quantizes the slot cache into freshly allocated pages (the caller
        checked the headroom with `pages_for_admission`)."""
        if self.paged:
            pages = self._alloc_pages(
                row, len(request.tokens) // self.engine._block())
            if pages is None:
                raise RuntimeError(
                    f"admit({row}): page headroom vanished between check "
                    "and allocation")
            self.cache = self.engine.write_pool_slot_paged(
                self.cache, slot_cache, row, pages)
        else:
            self.cache = self.engine.write_pool_slot(self.cache, slot_cache,
                                                     row)
        self.slots[row] = _Slot(request=request, emitted=[],
                                filled=len(request.tokens))
        self.activate(row, first_token)

    def begin_prefill(self, row: int, request: Request) -> None:
        """Chunked admission: claim `row` PREFILLING at t=0. The row rides
        the decode chunks finished-masked while `prefill_chunk_rows` /
        `prefill_remainder_rows` stream the prompt into its cache."""
        self.cache = self.engine.reset_pool_row(self.cache, row)
        self.cur[row] = EOS
        self.finished[row] = True
        self.slots[row] = _Slot(request=request, emitted=[],
                                state=PREFILLING, filled=0)

    def snapshot_rows(self, rows: Sequence[int],
                      tick: int) -> List[SlotSnapshot]:
        """Host snapshots of occupied `rows` at this chunk boundary."""
        subs = self.engine.snapshot_pool_rows(self.cache, rows)
        out = []
        for row, sub in zip(rows, subs):
            slot = self.slots[row]
            out.append(capture(
                rid=slot.request.rid, state=slot.state, filled=slot.filled,
                cur=int(self.cur[row]), finished=bool(self.finished[row]),
                emitted=slot.emitted, cache_rows=sub, tick=tick))
        return out

    def restore(self, row: int, request: Request,
                snap: SlotSnapshot) -> None:
        """Re-admit a preempted or faulted request from its snapshot: write
        its cache rows back and rebuild the slot. A paged restore writes
        the snapshot's pages into FRESH arena pages."""
        if self.paged:
            npv = int(snap.cache_rows["lengths"][0]) // self.engine._block()
            pages = self._alloc_pages(row, npv)
            if pages is None:
                raise RuntimeError(
                    f"restore({row}): page headroom vanished between check "
                    "and allocation")
            self.cache = self.engine.restore_pool_rows_paged(
                self.cache, snap.cache_rows, row, pages)
        else:
            self.cache = self.engine.restore_pool_rows(
                self.cache, snap.cache_rows, row)
        self.cur[row] = snap.cur
        self.finished[row] = snap.finished
        self.slots[row] = _Slot(request=request, emitted=list(snap.emitted),
                                state=snap.state, filled=snap.filled)

    def scrub_row(self, row: int) -> None:
        """Zero a quarantined row's cache leaves and position counter."""
        self.cache = self.engine.scrub_pool_row(self.cache, row)

    def corrupt_row(self, row: int, mode: str) -> None:
        """Fault-injection surface: corrupt row's cache leaves in place
        (mode 'nan' or 'garble'). On a paged pool the corruption hits the
        row's ring and its OWN pages only."""
        if self.paged:
            self.cache = self.engine.corrupt_pool_row_paged(
                self.cache, row, self.alloc.pages_of(row), mode)
        else:
            self.cache = self.engine.corrupt_pool_row(self.cache, row, mode)

    def prefill_chunk_rows(self, rows: List[int], tokens: np.ndarray,
                           n_valid: np.ndarray) -> torch.Tensor:
        """One padded, batched chunk forward over PREFILLING rows, padded to
        the pool size. Returns the rows' last-valid logits (device)."""
        self.cache, logits = self.engine.pool_prefill_chunk(
            self.cache, rows, tokens, n_valid, pad_to=self.max_batch)
        return logits

    def prefill_remainder_rows(self, rows: List[int],
                               tokens: np.ndarray) -> torch.Tensor:
        """Batched decode-path prefill of the final sub-block remainder
        (pool-size padded like `prefill_chunk_rows`)."""
        self.cache, logits = self.engine.pool_prefill_remainder(
            self.cache, rows, tokens, pad_to=self.max_batch)
        return logits

    # -- page bookkeeping (paged pools only) ------------------------------

    def pages_for_admission(self, entry: _QueueEntry) -> int:
        """Pages an entry must be able to allocate AT admission: its
        snapshot's committed pages (restore), the prompt's whole blocks
        (monolithic), or none (chunked: the table grows chunk by chunk in
        `ensure_row_pages`). A snapshot that fails its checksum is not
        trusted (admission will drop it and start from the prompt): a
        flipped `lengths` byte would otherwise ask for more pages than the
        arena has and block the queue for good, as it does in JAX."""
        if not self.paged:
            return 0
        c = self.engine._block()
        if entry.snapshot is not None and entry.snapshot.verify():
            return int(entry.snapshot.cache_rows["lengths"][0]) // c
        if self.engine.prefill_chunk:
            return 0
        return len(entry.request.tokens) // c

    def ensure_row_pages(self, row: int, target_tokens: int) -> bool:
        """Extend `row`'s page table to cover `target_tokens` (ceil to
        pages) and publish it to the device table. Returns False,
        allocating nothing, when the arena lacks the pages."""
        if not self.paged:
            return True
        need = pages_needed(target_tokens, self.engine._block()) \
            - len(self.alloc.pages_of(row))
        if need <= 0:
            return True
        if self._alloc_pages(row, need) is None:
            return False
        self.cache = self.engine.write_table_row(
            self.cache, row, self.alloc.pages_of(row))
        return True

    def activate(self, row: int, first_token: int) -> None:
        """Prefill complete: the row joins the decoding pool next chunk."""
        self.cur[row] = first_token
        self.finished[row] = False
        self.slots[row].state = DECODING

    def retire(self, row: int) -> None:
        if self.paged:
            # clear the device table BEFORE freeing: a stale entry over a
            # re-allocated page would let this idle (finished-masked but
            # still folding) row write into a live tenant's pages
            self.cache = self.engine.clear_table_row(self.cache, row)
            self.alloc.free_row(row)       # scrubs (zeroes) before reuse
        self.slots[row] = None
        self.cur[row] = EOS
        self.finished[row] = True

    def decode_chunk(self, n: int, generator: Optional[torch.Generator]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Run one n-step decode chunk over the pool (cache updated in
        place), sampling from `generator`. Returns (tokens (max_batch, n),
        bad (max_batch,)) after ONE device-to-host copy."""
        dev = self.engine.device
        toks, cur, finished, bad, self.cache = self.engine.decode_chunk_fn(
            torch.as_tensor(self.cur, device=dev),
            torch.as_tensor(self.finished, device=dev), self.cache, n,
            generator)
        host = torch.cat([toks, cur[:, None], finished[:, None].long(),
                          bad[:, None].long()], dim=1).cpu().numpy()
        self.cur = host[:, n].copy()
        self.finished = host[:, n + 1].astype(bool)
        return host[:, :n], host[:, n + 2].astype(bool)


class Scheduler:
    """SLO-aware continuous-batching scheduler: EDF-within-priority
    admission, preemptive eviction with snapshot resume, bounded-queue
    shedding, fault quarantine and retry. With every knob at its default
    (priority 0, no deadlines, unbounded queue, no injector) it is FCFS.
    See the module docstring."""

    def __init__(self, engine, max_batch: int,
                 generator: Optional[torch.Generator] = None, *,
                 max_queue: Optional[int] = None,
                 max_retries: int = 2,
                 snapshot_chunks: int = 0,
                 nan_guard: bool = True,
                 fault_injector=None):
        self.engine = engine
        self.pool = SlotPool(engine, max_batch)
        self.waiting: List[_QueueEntry] = []
        self.generator = engine.resolve_generator(generator)
        self.stats = ScheduleStats()
        self.max_queue = max_queue
        self.max_retries = max_retries
        # snapshot_chunks=k refreshes every occupied row's last good
        # snapshot each k-th executed chunk (0 = capture on preemption
        # only; fault recovery then requeues from scratch)
        self.snapshot_chunks = snapshot_chunks
        self.nan_guard = nan_guard
        self.fault_injector = fault_injector
        self.shed: Dict[int, ShedResult] = {}
        self.completed_at: Dict[int, int] = {}        # rid -> completion tick
        self.snapshots: Dict[int, SlotSnapshot] = {}  # row -> last good
        self._streamed: Dict[int, int] = {}  # rid -> on_token high-water
        #                                      mark (a requeued request must
        #                                      not stream tokens twice)
        self._seq = 0

    def submit(self, request: Request) -> None:
        """Queue a request. Past `max_queue`, shed the entry EDF values
        least (possibly the incoming one) with an explicit ShedResult."""
        entry = _QueueEntry(request=request, seq=self._seq)
        self._seq += 1
        if self.max_queue is not None and len(self.waiting) >= self.max_queue:
            victim = max(self.waiting + [entry],
                         key=lambda e: e.sort_key())
            self._shed(victim, SHED_QUEUE_FULL)
            if victim is entry:
                return
            self.waiting.remove(victim)
        self.waiting.append(entry)

    # -- internals -------------------------------------------------------

    def _shed(self, entry: _QueueEntry, reason: str) -> None:
        self.shed[entry.request.rid] = ShedResult(
            rid=entry.request.rid, reason=reason, tick=self.stats.ticks,
            priority=entry.request.priority)
        self.stats.sheds += 1

    def _needed_ticks(self, entry: _QueueEntry) -> int:
        """Optimistic lower bound on ticks to completion if admitted NOW:
        remaining chunked-prefill rounds + remaining decode chunks. Used
        only to shed provably infeasible deadlines."""
        req = entry.request
        emitted = len(entry.snapshot.emitted) if entry.snapshot else 0
        filled = entry.snapshot.filled if entry.snapshot \
            else (len(req.tokens) if not self.engine.prefill_chunk else 0)
        P = self.engine.prefill_chunk
        prefill_rounds = 0
        if P and filled < len(req.tokens):
            c = self.engine._block()
            nfull = (len(req.tokens) // c) * c
            prefill_rounds = max(0, math.ceil((nfull - filled) / P))
        decode_chunks = math.ceil(
            max(0, req.max_new_tokens - emitted) / self.engine.decode_chunk)
        return prefill_rounds + decode_chunks

    def _arrived(self) -> List[_QueueEntry]:
        """Waiting entries whose arrival time has passed, in EDF order;
        infeasible deadlines and, on a paged pool, requests the arena
        could never hold are shed."""
        tick = self.stats.ticks
        arrived = [e for e in self.waiting
                   if e.request.arrival_chunk <= tick]
        arrived.sort(key=lambda e: e.sort_key())
        feasible = []
        for e in arrived:
            dl = e.request.deadline_ticks
            if dl is not None and tick + self._needed_ticks(e) > dl:
                self.waiting.remove(e)
                self._shed(e, SHED_DEADLINE_INFEASIBLE)
            elif self.pool.paged and self._lifetime_pages(e.request) \
                    > self.pool.alloc.usable_pages:
                self.waiting.remove(e)
                self._shed(e, SHED_PAGES_EXHAUSTED)
            else:
                feasible.append(e)
        return feasible

    def _lifetime_pages(self, req: Request) -> int:
        """Pages `req` holds at its largest: prompt + decode budget."""
        return pages_needed(len(req.tokens) + req.max_new_tokens,
                            self.engine._block())

    def _page_headroom(self, entry: _QueueEntry,
                       extra_free: int = 0) -> bool:
        """Can `entry` allocate its admission pages right now (counting a
        prospective victim's pages as free)?"""
        if not self.pool.paged:
            return True
        return self.pool.pages_for_admission(entry) \
            <= self.pool.alloc.free_pages + extra_free

    def _admit_entry(self, row: int, entry: _QueueEntry) -> None:
        """Place one entry into a free row: a checksum-verified snapshot
        restore for a preempted or faulted entry, else a fresh prefill."""
        self.waiting.remove(entry)
        self.snapshots.pop(row, None)      # stale snapshot of a past tenant
        if entry.snapshot is not None:
            if entry.snapshot.verify():
                self.pool.restore(row, entry.request, entry.snapshot)
                slot = self.pool.slots[row]
                slot.seq, slot.retries = entry.seq, entry.retries
                return
            # corrupt snapshot, caught before its bytes reach the pool:
            # re-run from the prompt
            self.stats.snapshot_corruptions += 1
            entry.snapshot = None
        req = entry.request
        if self.engine.prefill_chunk > 0:
            self.pool.begin_prefill(row, req)
        else:
            slot_cache, first = self.engine.prefill_request(req.tokens,
                                                            self.generator)
            self.stats.prefill_forwards += 1      # one B=1 forward each
            self.stats.prefill_tokens += len(req.tokens)
            self.pool.admit(row, req, slot_cache, first)
        slot = self.pool.slots[row]
        slot.seq, slot.retries = entry.seq, entry.retries

    def _preempt_row(self, row: int) -> None:
        """Evict `row` mid-stream: snapshot its state (chunk boundary, so
        the state is clean) and requeue it with the snapshot attached."""
        slot = self.pool.slots[row]
        snap = self.pool.snapshot_rows([row], self.stats.ticks)[0]
        self.stats.snapshots += 1
        self.waiting.append(_QueueEntry(
            request=slot.request, seq=slot.seq, snapshot=snap,
            retries=slot.retries))
        self.snapshots.pop(row, None)
        self.pool.retire(row)
        self.stats.preemptions += 1

    def _admit_ready(self) -> None:
        """Fill free slots with arrived requests in EDF-within-priority
        order, then preempt: while the most urgent waiting arrival is
        STRICTLY more urgent than the least urgent occupied slot, evict
        that slot and admit the arrival in its place."""
        arrived = self._arrived()
        for row in self.pool.free_rows():
            if not arrived:
                return
            if not self._page_headroom(arrived[0]):
                # head-of-line blocking on purpose: admitting a later,
                # smaller entry past the most urgent one would invert EDF
                break
            self._admit_entry(row, arrived.pop(0))
        while arrived:
            entry = arrived.pop(0)
            occupied = self.pool.occupied_rows()
            if not occupied:
                break
            victim = max(occupied,
                         key=lambda r: _slot_sort_key(self.pool.slots[r]))
            if _slot_sort_key(self.pool.slots[victim])[0] \
                    <= entry.request.priority:
                break                      # nothing strictly less urgent
            if self.pool.paged and not self._page_headroom(
                    entry, extra_free=len(self.pool.alloc.pages_of(victim))):
                break            # eviction would not free enough pages
            self._preempt_row(victim)
            self._admit_entry(victim, entry)

    def _advance_prefill(self) -> None:
        """Advance every PREFILLING slot by ONE chunk, batching rows into
        shared forwards.

        Phase 1, whole-block chunks: every row with whole-block prompt
        tokens left joins ONE padded (g, prefill_chunk) forward (per-row
        `n_valid` and offsets, so any mix of prompt lengths and progress
        shares it); a row whose pages the arena cannot grow stalls.
        Phase 2, remainder: rows whose whole blocks are in feed their
        < block_size leftover tokens through batched decode steps, grouped
        by remainder length. Phase 3, activation: completed rows sample
        their first token from the final logits (one host sync) and decode
        from the next chunk on. If every page is held by stalled prefills
        and nothing can progress, the least urgent page holder is
        preempted."""
        P = self.engine.prefill_chunk
        c = self.engine._block()
        pf = [(row, s) for row, s in enumerate(self.pool.slots)
              if s is not None and s.state == PREFILLING]
        if not pf:
            return
        final: Dict[int, torch.Tensor] = {}     # row -> final logits (V,)

        chunk_rows = []
        starved: List[int] = []
        for row, s in pf:
            nfull = (len(s.request.tokens) // c) * c
            if s.filled < nfull:
                n = min(P, nfull - s.filled)
                # on-demand pages: this chunk folds blocks up to
                # (filled + n) / c, whose pages must exist first
                if not self.pool.ensure_row_pages(row, s.filled + n):
                    starved.append(row)    # stalls this round, keeps state
                    continue
                chunk_rows.append((row, s, n))
        if chunk_rows:
            g = len(chunk_rows)
            toks = np.zeros((g, P), np.int64)
            n_valid = np.zeros((g,), np.int64)
            for j, (row, s, n) in enumerate(chunk_rows):
                toks[j, :n] = s.request.tokens[s.filled:s.filled + n]
                n_valid[j] = n
            logits = self.pool.prefill_chunk_rows(
                [row for row, _, _ in chunk_rows], toks, n_valid)
            self.stats.prefill_forwards += 1
            self.stats.prefill_tokens += int(n_valid.sum())
            for j, (row, s, n) in enumerate(chunk_rows):
                s.filled += n
                if s.filled == len(s.request.tokens):
                    final[row] = logits[j]

        rem_groups: Dict[int, List[Tuple[int, _Slot]]] = {}
        for row, s in pf:
            rem = len(s.request.tokens) - s.filled
            if 0 < rem < c:
                rem_groups.setdefault(rem, []).append((row, s))
        for rem, group in sorted(rem_groups.items()):
            toks = np.asarray([s.request.tokens[s.filled:s.filled + rem]
                               for _, s in group], np.int64)
            logits = self.pool.prefill_remainder_rows(
                [row for row, _ in group], toks)
            self.stats.prefill_forwards += 1
            self.stats.prefill_tokens += rem * len(group)
            for j, (row, s) in enumerate(group):
                s.filled += rem
                final[row] = logits[j]

        if final:
            rows = sorted(final)
            # every activating row's first token in one host sync
            firsts = self.engine._sample(
                torch.stack([final[r] for r in rows]),
                self.generator).cpu().tolist()
            for row, first in zip(rows, firsts):
                self.pool.activate(row, first)

        if starved and not chunk_rows and not rem_groups \
                and self.pool.decoding_count == 0:
            # nothing in the pool can progress: every page is held by a
            # stalled prefill. Preempt the least urgent page holder (its
            # pages are zeroed and freed) so the others advance; it resumes
            # from its snapshot later.
            holders = [r for r in self.pool.occupied_rows()
                       if self.pool.alloc.pages_of(r)]
            if not holders:
                raise RuntimeError(
                    "page-starved prefill with an empty arena: a single "
                    "chunk outgrows the usable pages (the admission "
                    "feasibility check should have shed this request)")
            victim = max(holders,
                         key=lambda r: _slot_sort_key(self.pool.slots[r]))
            self.stats.page_preemptions += 1
            self._preempt_row(victim)

    def _ensure_decode_pages(self, chunk: int) -> None:
        """Before a decode chunk, grow every DECODING row's page table to
        cover the chunk's folds. On exhaustion, preempt the least urgent
        page-holding row (the needy row itself if it IS the least urgent)
        until the chunk is covered."""
        if not self.pool.paged:
            return
        rows = [(r, s) for r, s in enumerate(self.pool.slots)
                if s is not None and s.state == DECODING]
        for row, s in rows:
            if self.pool.slots[row] is not s:
                continue                   # preempted below, mid-loop
            life = len(s.request.tokens) + s.request.max_new_tokens
            # host upper bound on the row's position: committed prompt +
            # emitted + the pending sampled token
            target = min(life, s.filled + len(s.emitted) + 1 + chunk)
            while not self.pool.ensure_row_pages(row, target):
                holders = [r for r in self.pool.occupied_rows()
                           if r != row and self.pool.alloc.pages_of(r)]
                victim = row
                if holders:
                    cand = max(holders, key=lambda r: _slot_sort_key(
                        self.pool.slots[r]))
                    if _slot_sort_key(self.pool.slots[cand]) \
                            >= _slot_sort_key(s):
                        victim = cand      # never evict a MORE urgent row
                self.stats.page_preemptions += 1
                self._preempt_row(victim)
                if victim == row:
                    break                  # the row yielded its own slot

    # -- faults ----------------------------------------------------------

    def _capture_snapshots(self) -> None:
        """Refresh every occupied row's last good snapshot at this chunk
        boundary."""
        rows = self.pool.occupied_rows()
        if not rows:
            return
        for row, snap in zip(rows, self.pool.snapshot_rows(
                rows, self.stats.ticks)):
            self.snapshots[row] = snap
            self.stats.snapshots += 1

    def _quarantine(self, row: int) -> None:
        """Isolate a faulty row: drop its poisoned chunk, scrub the row, and
        requeue the request from its last good snapshot, or from scratch.
        Bounded by `max_retries`; exhaustion sheds the request. Neighbour
        rows are untouched."""
        slot = self.pool.slots[row]
        self.stats.quarantines += 1
        snap = self.snapshots.pop(row, None)
        if snap is not None and snap.rid != slot.request.rid:
            snap = None                    # snapshot of a previous tenant
        entry = _QueueEntry(request=slot.request, seq=slot.seq,
                            snapshot=snap, retries=slot.retries + 1)
        self.pool.retire(row)
        self.pool.scrub_row(row)
        if entry.retries > self.max_retries:
            self._shed(entry, SHED_RETRIES_EXHAUSTED)
            return
        self.stats.retries += 1
        self.waiting.append(entry)

    def _collect_faults(self, bad: np.ndarray) -> Set[int]:
        """Rows to quarantine after a chunk: the NaN guard's flags on live
        DECODING rows plus the injector's failure reports."""
        faulted: Set[int] = set()
        if self.nan_guard:
            for row in np.flatnonzero(bad):
                slot = self.pool.slots[row]
                if slot is not None and slot.state == DECODING:
                    faulted.add(int(row))
        if self.fault_injector is not None:
            for row in self.fault_injector.failed_rows(self.stats.chunks):
                if self.pool.slots[row] is not None:
                    faulted.add(int(row))
        return faulted

    def _drain_chunk(self, toks: np.ndarray,
                     on_token: Optional[Callable[[int, int], None]],
                     on_complete: Optional[Callable[[int, List[int]], None]],
                     results: Dict[int, object]) -> None:
        """Distribute a chunk's tokens to their requests; retire EOS'd or
        budget-exhausted slots. A requeued request's already streamed
        tokens are not streamed again (`_streamed` high-water mark)."""
        for row in range(self.pool.max_batch):
            slot = self.pool.slots[row]
            if slot is None or slot.state != DECODING:
                continue                 # PREFILLING rows rode along masked
            done = False
            rid = slot.request.rid
            budget = slot.request.max_new_tokens
            for tok in toks[row].tolist():
                # budget check BEFORE appending: emit at most `budget`
                if tok == EOS or len(slot.emitted) >= budget:
                    done = True
                    break
                slot.emitted.append(tok)
                if on_token is not None \
                        and len(slot.emitted) > self._streamed.get(rid, 0):
                    self._streamed[rid] = len(slot.emitted)
                    on_token(rid, tok)
            if len(slot.emitted) >= budget:
                done = True
            if done:
                results[rid] = slot.emitted
                self.completed_at[rid] = self.stats.ticks
                dl = slot.request.deadline_ticks
                if dl is not None and self.stats.ticks > dl:
                    self.stats.deadline_misses += 1
                if on_complete is not None:
                    on_complete(rid, slot.emitted)
                self.snapshots.pop(row, None)
                self.pool.retire(row)

    # -- main loop -------------------------------------------------------

    def run(self, on_token: Optional[Callable[[int, int], None]] = None,
            on_complete: Optional[Callable[[int, List[int]], None]] = None
            ) -> Dict[int, object]:
        """Drive the pool until every submitted request completes or is
        shed. Returns {rid: tokens} (EOS excluded, capped at
        max_new_tokens), with a `ShedResult` for a shed request."""
        results: Dict[int, object] = {}
        chunk = self.engine.decode_chunk
        while self.waiting or self.pool.occupancy:
            self._admit_ready()
            if self.engine.prefill_chunk:
                self._advance_prefill()
            self._ensure_decode_pages(chunk)
            decoding = self.pool.decoding_count
            if not decoding:
                # nothing to decode yet (empty pool, or every occupied slot
                # still prefilling): virtual time passes for the arrivals
                self.stats.idle_ticks += 1
                continue
            if self.snapshot_chunks and \
                    self.stats.chunks % self.snapshot_chunks == 0:
                self._capture_snapshots()
            if self.fault_injector is not None:
                self.fault_injector.before_chunk(self.pool, self.snapshots,
                                                 self.stats.chunks)
            toks, bad = self.pool.decode_chunk(chunk, self.generator)
            faulted = self._collect_faults(bad)
            self.stats.chunks += 1
            self.stats.row_steps += decoding * chunk
            self.stats.occupancy_sum += self.pool.occupancy \
                / self.pool.max_batch
            for row in sorted(faulted):
                self._quarantine(row)      # retires the row: drain skips it
            self._drain_chunk(toks, on_token, on_complete, results)
        results.update(self.shed)
        return results

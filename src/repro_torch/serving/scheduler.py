"""FCFS slot-based continuous-batching scheduler over the device-resident
decode loop.

Counterpart of the FCFS subset of ``repro/serving/scheduler.py``: monolithic
and chunked admission, the dense and the paged pool; no priorities,
deadlines, preemption, faults or telemetry (those come with later slices).

The unit of work is a slot, one row of a fixed (max_batch)-row pool cache,
mutated only between decode chunks:

* admission: arrived requests, in submission order, claim free slots. With
  `engine.prefill_chunk == 0` (monolithic) each is prefilled alone (B=1)
  and copied into its row. With `engine.prefill_chunk > 0` (chunked) the
  slot is claimed PREFILLING at t=0 and the prompt streams into the pool
  one chunk per round (`_advance_prefill`), every co-prefilling row sharing
  one padded forward, interleaved with everyone else's decode chunks;
* decode: the pool decodes `decode_chunk` tokens on the device with ONE
  host sync per chunk, which also carries a per-row non-finite-logits flag;
  PREFILLING rows ride along finished-masked;
* retirement: after the sync, an EOS or an exhausted budget frees the slot.

Paged pools: the `SlotPool` owns a `PageAllocator` beside the cache. Pages
are allocated at admission (monolithic: the prompt's whole blocks) or on
demand (each chunk's folds, each decode chunk's folds), published to the
device page table, and freed (zeroed first) at retirement. A request whose
prompt + budget could never fit the arena is shed up front with an explicit
`ShedResult` (`SHED_PAGES_EXHAUSTED`). Where the JAX scheduler would preempt
a row to free pages (page pressure, which needs the snapshot machinery not
ported yet), this one raises a RuntimeError naming the missing feature; the
default, capacity-equivalent arena never gets there.

Greedy decode of a request depends only on its own prompt (per-row masks
make every row's attention independent of its neighbours), so continuous
scheduling gives the same tokens as the static bucketed baseline, and
chunked admission the same tokens as monolithic admission when the cache
dtype is the activation dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import EOS
from repro_torch.serving.paged import PageAllocator, pages_needed

# ShedResult reason: the request's lifetime page need exceeds the whole
# arena, so it could never run to completion
SHED_PAGES_EXHAUSTED = "pages_exhausted"

# Slot states: a monolithically admitted slot is born DECODING; under
# chunked admission a slot is born PREFILLING and flips to DECODING when its
# first token is sampled.
PREFILLING = "prefilling"
DECODING = "decoding"

_PREEMPTION_MISSING = (
    "preemption under page pressure is not ported yet (it needs the "
    "snapshot/restore machinery of the SLO slice); serve with a larger "
    "arena_pages (the default, None, is capacity-equivalent and never "
    "needs it)")


@dataclasses.dataclass
class Request:
    """One generation request; admissible once `arrival_chunk` chunks of
    virtual time have passed (0 = at once)."""

    rid: int
    tokens: Tuple[int, ...]
    max_new_tokens: int
    arrival_chunk: int = 0

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


@dataclasses.dataclass(frozen=True)
class ShedResult:
    """Explicit rejection, returned in place of the token list."""

    rid: int
    reason: str        # SHED_PAGES_EXHAUSTED
    tick: int          # virtual time of the decision


@dataclasses.dataclass
class _Slot:
    request: Request
    emitted: List[int]
    state: str = DECODING
    filled: int = 0             # prompt tokens committed to the cache


@dataclasses.dataclass
class ScheduleStats:
    chunks: int = 0             # decode chunks executed
    idle_ticks: int = 0         # ticks with nothing to decode
    row_steps: int = 0          # DECODING-slot steps
    occupancy_sum: float = 0.0  # Σ per-chunk occupied fraction
    prefill_forwards: int = 0   # prefill launches (B=1, chunk or remainder)
    prefill_tokens: int = 0     # real prompt tokens prefilled
    sheds: int = 0              # explicit ShedResults
    bad_rows: int = 0           # rows flagged with non-finite logits

    @property
    def ticks(self) -> int:
        """Virtual time: executed chunks + idle ticks (arrival clock)."""
        return self.chunks + self.idle_ticks

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(self.chunks, 1)


class SlotPool:
    """Sole owner of the live pool cache, the per-slot decode state and, for
    a paged pool, the page allocator. Host mirrors `cur`/`finished` are
    uploaded at each chunk and refreshed at its one sync."""

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

    def pages_for_admission(self, request: Request) -> int:
        """Pages a request must be able to allocate at admission: the
        prompt's whole blocks (monolithic), or none (chunked: the table
        grows chunk by chunk in `ensure_row_pages`)."""
        if not self.paged or self.engine.prefill_chunk:
            return 0
        return len(request.tokens) // self.engine._block()

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

    def decode_chunk(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Run one n-step decode chunk over the pool (cache updated in
        place). Returns (tokens (max_batch, n), bad (max_batch,)) after ONE
        device-to-host copy."""
        dev = self.engine.device
        toks, cur, finished, bad, self.cache = self.engine.decode_chunk_fn(
            torch.as_tensor(self.cur, device=dev),
            torch.as_tensor(self.finished, device=dev), self.cache, n)
        host = torch.cat([toks, cur[:, None], finished[:, None].long(),
                          bad[:, None].long()], dim=1).cpu().numpy()
        self.cur = host[:, n].copy()
        self.finished = host[:, n + 1].astype(bool)
        return host[:, :n], host[:, n + 2].astype(bool)


class Scheduler:
    """FCFS continuous-batching scheduler (see the module docstring)."""

    def __init__(self, engine, max_batch: int):
        self.engine = engine
        self.pool = SlotPool(engine, max_batch)
        self.waiting: List[Request] = []
        self.stats = ScheduleStats()
        self.shed: Dict[int, ShedResult] = {}
        self.bad: Dict[int, int] = {}              # rid -> flagged tick

    def submit(self, request: Request) -> None:
        self.waiting.append(request)

    def _shed(self, req: Request, reason: str) -> None:
        self.waiting.remove(req)
        self.shed[req.rid] = ShedResult(rid=req.rid, reason=reason,
                                        tick=self.stats.ticks)
        self.stats.sheds += 1

    def _lifetime_pages(self, req: Request) -> int:
        """Pages `req` holds at its largest: prompt + decode budget."""
        return pages_needed(len(req.tokens) + req.max_new_tokens,
                            self.engine._block())

    def _arrived(self) -> List[Request]:
        """Waiting requests whose arrival time has passed, in FCFS order;
        those a paged pool could never hold are shed."""
        tick = self.stats.ticks
        arrived = []
        for r in [r for r in self.waiting if r.arrival_chunk <= tick]:
            if self.pool.paged and self._lifetime_pages(r) \
                    > self.pool.alloc.usable_pages:
                self._shed(r, SHED_PAGES_EXHAUSTED)
            else:
                arrived.append(r)
        return arrived

    def _admit_entry(self, row: int, req: Request) -> None:
        self.waiting.remove(req)
        if self.engine.prefill_chunk > 0:
            self.pool.begin_prefill(row, req)
            return
        slot_cache, first = self.engine.prefill_request(req.tokens)
        self.stats.prefill_forwards += 1          # one B=1 forward each
        self.stats.prefill_tokens += len(req.tokens)
        self.pool.admit(row, req, slot_cache, first)

    def _admit_ready(self) -> None:
        arrived = self._arrived()
        for row in self.pool.free_rows():
            if not arrived:
                return
            if self.pool.paged and self.pool.pages_for_admission(arrived[0]) \
                    > self.pool.alloc.free_pages:
                return        # head-of-line: the oldest request goes first
            self._admit_entry(row, arrived.pop(0))

    def _advance_prefill(self) -> None:
        """Advance every PREFILLING slot by ONE chunk, batching rows into
        shared forwards.

        Phase 1, whole-block chunks: every row with whole-block prompt
        tokens left joins ONE padded (g, prefill_chunk) forward (per-row
        `n_valid` and offsets, so any mix of prompt lengths and progress
        shares it). Phase 2, remainder: rows whose whole blocks are in feed
        their < block_size leftover tokens through batched decode steps,
        grouped by remainder length. Phase 3, activation: completed rows
        take their first token from the final logits and decode from the
        next chunk on."""
        P = self.engine.prefill_chunk
        c = self.engine._block()
        pf = [(row, s) for row, s in enumerate(self.pool.slots)
              if s is not None and s.state == PREFILLING]
        if not pf:
            return
        final: List[Tuple[int, torch.Tensor, int]] = []  # (row, logits, j)

        chunk_rows = []
        starved = 0
        for row, s in pf:
            nfull = (len(s.request.tokens) // c) * c
            if s.filled < nfull:
                n = min(P, nfull - s.filled)
                # on-demand pages: this chunk folds blocks up to
                # (filled + n) / c, whose pages must exist first
                if not self.pool.ensure_row_pages(row, s.filled + n):
                    starved += 1           # stalls this round, keeps state
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
                    final.append((row, logits, j))

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
                final.append((row, logits, j))

        if final:
            # every activating row's first token in one host sync
            firsts = torch.stack([torch.argmax(lg[j], dim=-1)
                                  for _, lg, j in final]).cpu().tolist()
            for (row, _, _), first in sorted(zip(final, firsts)):
                self.pool.activate(row, first)

        if starved and not chunk_rows and not rem_groups \
                and self.pool.decoding_count == 0:
            # nothing in the pool can progress: every page is held by a
            # stalled prefill; the JAX scheduler preempts one row here
            raise RuntimeError(
                f"page-starved prefill ({starved} rows stalled, none able "
                f"to progress): {_PREEMPTION_MISSING}")

    def _ensure_decode_pages(self, chunk: int) -> None:
        """Before a decode chunk, grow every DECODING row's page table to
        cover the chunk's folds."""
        if not self.pool.paged:
            return
        for row, s in enumerate(self.pool.slots):
            if s is None or s.state != DECODING:
                continue
            life = len(s.request.tokens) + s.request.max_new_tokens
            # host upper bound on the row's position: committed prompt +
            # emitted + the pending sampled token
            target = min(life, s.filled + len(s.emitted) + 1 + chunk)
            if not self.pool.ensure_row_pages(row, target):
                raise RuntimeError(
                    f"row {row} needs pages for its next decode chunk and "
                    f"the arena has {self.pool.alloc.free_pages} free: "
                    f"{_PREEMPTION_MISSING}")

    def _drain_chunk(self, toks: np.ndarray, bad: np.ndarray,
                     on_token: Optional[Callable[[int, int], None]],
                     on_complete: Optional[Callable[[int, List[int]], None]],
                     results: Dict[int, object]) -> None:
        """Distribute a chunk's tokens to their requests; retire EOS'd or
        budget-exhausted slots. PREFILLING rows rode along masked."""
        for row in range(self.pool.max_batch):
            slot = self.pool.slots[row]
            if slot is None or slot.state != DECODING:
                continue
            rid = slot.request.rid
            if bad[row]:
                self.stats.bad_rows += 1
                self.bad.setdefault(rid, self.stats.ticks)
            budget = slot.request.max_new_tokens
            done = False
            for tok in toks[row].tolist():
                if tok == EOS or len(slot.emitted) >= budget:
                    done = True
                    break
                slot.emitted.append(tok)
                if on_token is not None:
                    on_token(rid, tok)
            if len(slot.emitted) >= budget:
                done = True
            if done:
                results[rid] = slot.emitted
                if on_complete is not None:
                    on_complete(rid, slot.emitted)
                self.pool.retire(row)

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
            toks, bad = self.pool.decode_chunk(chunk)
            self.stats.chunks += 1
            self.stats.row_steps += decoding * chunk
            self.stats.occupancy_sum += self.pool.occupancy \
                / self.pool.max_batch
            self._drain_chunk(toks, bad, on_token, on_complete, results)
        results.update(self.shed)
        return results

"""FCFS slot-based continuous-batching scheduler over the device-resident
decode loop.

Counterpart of the FCFS subset of ``repro/serving/scheduler.py``: monolithic
admission, no priorities, deadlines, preemption, faults, paging, chunked
prefill or telemetry (those come with later slices).

The unit of work is a slot, one row of a fixed (max_batch)-row pool cache,
mutated only between decode chunks:

* admission: arrived requests, in submission order, claim free slots; each
  is prefilled alone (B=1) and copied into its row;
* decode: the pool decodes `decode_chunk` tokens on the device with ONE
  host sync per chunk, which also carries a per-row non-finite-logits flag;
* retirement: after the sync, an EOS or an exhausted budget frees the slot.

Greedy decode of a request depends only on its own prompt (per-row masks
make every row's attention independent of its neighbours), so continuous
scheduling gives the same tokens as the static bucketed baseline.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import EOS


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


@dataclasses.dataclass
class _Slot:
    request: Request
    emitted: List[int]


@dataclasses.dataclass
class ScheduleStats:
    chunks: int = 0             # decode chunks executed
    idle_ticks: int = 0         # ticks with nothing to decode
    row_steps: int = 0          # decoding-slot steps
    occupancy_sum: float = 0.0  # Σ per-chunk occupied fraction
    prefill_forwards: int = 0   # admission prefills (one B=1 each)
    prefill_tokens: int = 0     # prompt tokens prefilled
    bad_rows: int = 0           # rows flagged with non-finite logits

    @property
    def ticks(self) -> int:
        """Virtual time: executed chunks + idle ticks (arrival clock)."""
        return self.chunks + self.idle_ticks

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(self.chunks, 1)


class SlotPool:
    """Sole owner of the live pool cache and the per-slot decode state.
    Host mirrors `cur`/`finished` are uploaded at each chunk and refreshed
    at its one sync."""

    def __init__(self, engine, max_batch: int):
        self.engine = engine
        self.max_batch = max_batch
        self.cache = engine.init_pool_cache(max_batch)
        self.cur = np.full((max_batch,), EOS, np.int64)
        self.finished = np.ones((max_batch,), bool)
        self.slots: List[Optional[_Slot]] = [None] * max_batch

    def free_rows(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def occupancy(self) -> int:
        return sum(s is not None for s in self.slots)

    def admit(self, row: int, request: Request, slot_cache: Dict,
              first_token: int) -> None:
        """Write a prefilled request (B=1 cache at the prompt length, first
        sampled token) into `row`."""
        self.cache = self.engine.write_pool_slot(self.cache, slot_cache, row)
        self.activate(row, first_token)
        self.slots[row] = _Slot(request=request, emitted=[])

    def activate(self, row: int, first_token: int) -> None:
        self.cur[row] = first_token
        self.finished[row] = False

    def retire(self, row: int) -> None:
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
        self.bad: Dict[int, int] = {}              # rid -> flagged tick

    def submit(self, request: Request) -> None:
        self.waiting.append(request)

    def _arrived(self) -> List[Request]:
        """Waiting requests whose arrival time has passed, in FCFS order."""
        tick = self.stats.ticks
        return [r for r in self.waiting if r.arrival_chunk <= tick]

    def _admit_entry(self, row: int, req: Request) -> None:
        self.waiting.remove(req)
        slot_cache, first = self.engine.prefill_request(req.tokens)
        self.stats.prefill_forwards += 1
        self.stats.prefill_tokens += len(req.tokens)
        self.pool.admit(row, req, slot_cache, first)

    def _admit_ready(self) -> None:
        arrived = self._arrived()
        for row in self.pool.free_rows():
            if not arrived:
                return
            self._admit_entry(row, arrived.pop(0))

    def _drain_chunk(self, toks: np.ndarray, bad: np.ndarray,
                     on_token: Optional[Callable[[int, int], None]],
                     on_complete: Optional[Callable[[int, List[int]], None]],
                     results: Dict[int, List[int]]) -> None:
        """Distribute a chunk's tokens to their requests; retire EOS'd or
        budget-exhausted slots."""
        for row in range(self.pool.max_batch):
            slot = self.pool.slots[row]
            if slot is None:
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
            ) -> Dict[int, List[int]]:
        """Drive the pool until every submitted request completes. Returns
        {rid: tokens} (EOS excluded, capped at max_new_tokens)."""
        results: Dict[int, List[int]] = {}
        chunk = self.engine.decode_chunk
        while self.waiting or self.pool.occupancy:
            self._admit_ready()
            decoding = self.pool.occupancy
            if not decoding:
                self.stats.idle_ticks += 1
                continue
            toks, bad = self.pool.decode_chunk(chunk)
            self.stats.chunks += 1
            self.stats.row_steps += decoding * chunk
            self.stats.occupancy_sum += decoding / self.pool.max_batch
            self._drain_chunk(toks, bad, on_token, on_complete, results)
        return results

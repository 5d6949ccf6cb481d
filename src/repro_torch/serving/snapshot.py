"""Host-side slot snapshots: the preemption and fault-recovery unit.

Counterpart of ``repro/serving/snapshot.py``. A `SlotSnapshot` is what it
takes to resume one request on any free pool row: host copies of the row's
cache leaves (the engine's `snapshot_pool_rows` slice, O(c + M) per row
thanks to the compressed prefix), the next un-emitted sampled token
(`cur`), the finished flag, the emitted tokens and the chunked-prefill
progress (`state`, `filled`).

Snapshots are captured at chunk boundaries, where a slot's state is clean:
restoring the cache rows and re-entering the decode loop replays exactly
the steps an uninterrupted run would have taken.

The leaves are CPU torch tensors, not numpy arrays: numpy has neither bf16
nor float8_e4m3fn (the paged pool's fp8 pages). Integrity: `checksum` is a
CRC32 over every leaf's raw bytes (read through a uint8 view), in sorted
key order, so bf16 and fp8 payloads and every fp32 scale leaf are covered:
a scale-only bit flip fails `verify()` like a payload flip.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List

import torch


def leaf_bytes(leaf: torch.Tensor) -> torch.Tensor:
    """A host leaf's raw bytes as a flat uint8 view (no copy for a
    contiguous leaf): the surface both the checksum and the fault
    injector's byte flip work on."""
    return leaf.contiguous().reshape(-1).view(torch.uint8)


def cache_rows_checksum(cache_rows: Dict[str, torch.Tensor]) -> int:
    """CRC32 over the snapshot's cache bytes (key order fixed by sort)."""
    crc = 0
    for key in sorted(cache_rows):
        crc = zlib.crc32(leaf_bytes(cache_rows[key]).numpy().tobytes(), crc)
    return crc


@dataclasses.dataclass
class SlotSnapshot:
    """Resume state for one request, captured at a chunk boundary."""

    rid: int
    state: str                             # scheduler slot state at capture
    filled: int                            # prompt tokens committed (chunked)
    cur: int                               # next un-emitted sampled token
    finished: bool                         # EOS already sampled into `cur`
    emitted: List[int]                     # tokens emitted up to the boundary
    cache_rows: Dict[str, torch.Tensor]    # host copies, batch-of-1 leaves
    checksum: int                          # CRC32 of cache_rows at capture
    tick: int                              # virtual time of capture

    def verify(self) -> bool:
        """True iff the cache bytes still match the capture-time checksum."""
        return cache_rows_checksum(self.cache_rows) == self.checksum

    @property
    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size()
                   for v in self.cache_rows.values())


def capture(rid: int, state: str, filled: int, cur: int, finished: bool,
            emitted: List[int], cache_rows: Dict[str, torch.Tensor],
            tick: int) -> SlotSnapshot:
    """Build a snapshot, owning host copies of the mutable pieces."""
    rows = {k: v.detach().to("cpu", memory_format=torch.contiguous_format,
                             copy=True)
            for k, v in cache_rows.items()}
    return SlotSnapshot(rid=rid, state=state, filled=filled, cur=int(cur),
                        finished=bool(finished), emitted=list(emitted),
                        cache_rows=rows,
                        checksum=cache_rows_checksum(rows), tick=tick)

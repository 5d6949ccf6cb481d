"""Sequence parallelism: the communication-cost model.

Counterpart of the comm-byte half of ``repro/core/seq_parallel.py``
(docs/parallelism.md §Comm bytes), copied as plain arithmetic: the
telemetry's cost attribution (`telemetry/cost.py`) reads it. The
sequence-parallel attention itself comes with the multi-GPU slice.
"""
from __future__ import annotations

from typing import Tuple


def seq_parallel_comm_bytes(n: int, k: int, d_total: int, shards: int,
                            dtype_bytes: int = 2) -> Tuple[int, int]:
    """(linformer_bytes, ring_attention_bytes) per device for one layer of
    the EXACT form: a psum of K̄/V̄ vs a ring exchange of raw K/V."""
    lin = 2 * k * d_total * dtype_bytes                   # psum of K̄,V̄
    ring = 2 * (n // shards) * d_total * (shards - 1) * dtype_bytes
    return lin, ring


def blockwise_sp_comm_bytes(n: int, block_size: int, block_slots: int,
                            d_total: int, shards: int,
                            dtype_bytes: int = 2) -> Tuple[int, int]:
    """(linformer_bytes, ring_attention_bytes) per device for one layer of
    the CAUSAL (blockwise) form under sequence parallelism: the all-gather
    moves only the compressed prefix — 2·(n/c)·r·d bytes, a c/r-fold
    reduction over ring-exchanging the raw K/V — while the local causal
    blocks never leave their shard."""
    m_total = (n // block_size) * block_slots
    lin = 2 * m_total * d_total * dtype_bytes             # all-gather of k̄,v̄
    ring = 2 * (n // shards) * d_total * (shards - 1) * dtype_bytes
    return lin, ring

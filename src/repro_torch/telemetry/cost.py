"""Cost attribution for a resolved `AttentionPlan`.

Counterpart of ``repro/telemetry/cost.py``. Turns a (plan, AttentionConfig,
shape) triple into a JSON-serializable attribution record: per attention
form, the resolved backend, which mesh axes it actually shards over, an
analytic FLOPs estimate, and the per-device communication bytes from the
comm-cost model in `core/seq_parallel.py` (docs/parallelism.md §Comm
bytes). The launchers dump one such record per run into the telemetry
JSONL so a number always travels with the execution plan that produced it.

The port's plan is single-device (`parallel/plan.py`): it carries the
`backend` and `backward_impl` knobs and no mesh. The record holds the
values JAX's single-device plan carries: tp = sp = 1, no data axes, no
manual region, no axis names, and no communication; `backend` is the name
after resolution (`kernels/common.RESOLVED_BACKENDS`). The record equals
JAX's key for key.

FLOPs conventions: one multiply-accumulate = 2 FLOPs; estimates cover
the attention contractions only (QK^T + PV, plus the K/V sequence
projection for the exact form) — projections to/from the residual stream
belong to the surrounding block, not the mixer.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import AttentionConfig
from repro_torch.core.seq_parallel import (blockwise_sp_comm_bytes,
                                           seq_parallel_comm_bytes)
from repro_torch.kernels.common import RESOLVED_BACKENDS

# The single-device plan's mesh: no tensor or sequence parallelism, no
# batch axes inside a manual region (the multi-GPU slice fills these in).
_TP = _SP = 1
_DATA_AXES = ()


def exact_attention_flops(batch: int, seq: int, acfg: AttentionConfig) -> int:
    """Exact Linformer form: project K/V to k slots (2 projections), then
    QK̄^T + P·V̄ over the k compressed slots."""
    h, hkv, dh = acfg.num_heads, acfg.num_kv_heads, acfg.head_dim
    k = acfg.linformer.k
    proj = 2 * (2 * batch * seq * k * hkv * dh)
    attn = 2 * (2 * batch * seq * k * h * dh)
    return proj + attn


def _m_total(seq: int, acfg: AttentionConfig) -> int:
    lin = acfg.linformer
    return (seq // lin.block_size) * lin.block_slots


def causal_attention_flops(batch: int, seq: int, acfg: AttentionConfig) -> int:
    """Blockwise-causal form: each query attends to its c-token local block
    plus (at most) all M = (S/c)·r compressed slots — the O(n) claim is
    that c + M grows ~linearly in n for fixed c, r."""
    h, dh = acfg.num_heads, acfg.head_dim
    lin = acfg.linformer
    ctx = lin.block_size + _m_total(seq, acfg)
    comp = 2 * (2 * batch * seq * lin.block_slots * dh)   # conv compression
    attn = 2 * (2 * batch * seq * ctx * h * dh)
    return comp + attn


def chunk_prefill_flops(batch: int, chunk: int, seq: int,
                        acfg: AttentionConfig) -> int:
    """One admission-prefill chunk of `chunk` tokens against a cache
    provisioned for `seq` (the pinned compressed buffer is M(seq) slots)."""
    h, dh = acfg.num_heads, acfg.head_dim
    ctx = acfg.linformer.block_size + _m_total(seq, acfg)
    return 2 * (2 * batch * chunk * ctx * h * dh)


def decode_token_flops(batch: int, seq: int, acfg: AttentionConfig) -> int:
    """One decode step: a single query row against [raw ring | compressed
    slots] — c + M(seq) keys per head."""
    h, dh = acfg.num_heads, acfg.head_dim
    ctx = acfg.linformer.block_size + _m_total(seq, acfg)
    return 2 * (2 * batch * 1 * ctx * h * dh)


def plan_attribution(plan, acfg: AttentionConfig, *, max_seq: int,
                     batch: int = 1,
                     prefill_chunk: Optional[int] = None) -> Dict:
    """One JSON-serializable record describing how `plan` will execute each
    attention form of `acfg` at (batch, max_seq) scale."""
    lin = acfg.linformer
    d_total = acfg.num_kv_heads * acfg.head_dim
    backend = RESOLVED_BACKENDS[plan.backend]
    sp = _SP
    lin_bytes, ring_bytes = blockwise_sp_comm_bytes(
        max_seq, lin.block_size, lin.block_slots, d_total, max(sp, 2))
    exact_lin, exact_ring = seq_parallel_comm_bytes(
        max_seq, lin.k, d_total, max(sp, 2))
    chunk = prefill_chunk or lin.block_size

    def form(name: str, *, flops: int, comm_bytes: int) -> Dict:
        return {
            "form": name,
            "backend": backend,
            "manual": False,
            "tp_axis": None,
            "sp_axis": None,
            "est_flops": int(flops),
            "comm_bytes_per_device": int(comm_bytes if sp > 1 else 0),
        }

    return {
        "kind": "plan_attribution",
        "attention_kind": acfg.kind,
        "backend": backend,
        "backward_impl": plan.backward_impl,
        "tp": _TP,
        "sp": sp,
        "data_axes": list(_DATA_AXES),
        "batch": batch,
        "max_seq": max_seq,
        "block_size": lin.block_size,
        "block_slots": lin.block_slots,
        "compressed_slots_total": _m_total(max_seq, acfg),
        # ring_bytes: what a ring-attention exchange of raw K/V would cost —
        # the denominator of the Linformer comm win quoted in
        # docs/parallelism.md.
        "ring_bytes_per_device": int(ring_bytes if sp > 1 else 0),
        "exact_ring_bytes_per_device": int(exact_ring if sp > 1 else 0),
        "forms": [
            form("train_causal",
                 flops=causal_attention_flops(batch, max_seq, acfg),
                 comm_bytes=lin_bytes),
            form("exact",
                 flops=exact_attention_flops(batch, max_seq, acfg),
                 comm_bytes=exact_lin),
            form("chunk_prefill",
                 flops=chunk_prefill_flops(batch, chunk, max_seq, acfg),
                 comm_bytes=lin_bytes),
            # decode is head-parallel only: no sequence communication
            form("decode",
                 flops=decode_token_flops(batch, max_seq, acfg),
                 comm_bytes=0),
        ],
    }

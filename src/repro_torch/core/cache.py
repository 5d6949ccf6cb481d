"""Decode-time compressed (Linformer-causal) cache.

Counterpart of the compressed-cache half of ``repro/core/cache.py``. Per
layer the cache holds (a) a raw ring buffer for the current, incomplete
block of K/V and (b) r compressed slots per completed block. A context of
length n costs c + r·⌊n/c⌋ slots instead of n.

Caches are plain dicts of tensors with the layer axis leading:
``raw_k``/``raw_v`` (L, B, c, Hkv, Dh), ``comp_k``/``comp_v``
(L, B, M, Hkv, Dh) with M = (max_seq/c)·r, and ``lengths`` (B,) int32, one
position counter per batch row: rows of a continuous batch sit at unequal
positions, and every mask, ring write and block fold is per row.

Unlike the JAX package, whose arrays are immutable, the decode step updates
the cache IN PLACE: the ring write and the block fold write into the layer
slices they are given (views into the pool), so a step never copies the
pool. Writes follow ``jax.lax.dynamic_update_slice``: an out-of-range start
is clamped, and every row is written, finished rows included (only their
``lengths`` are frozen, by the decode scan).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def rowwise_t(t, batch: int, device) -> torch.Tensor:
    """Broadcast a scalar position to a (B,) per-row position vector."""
    t = torch.as_tensor(t, dtype=torch.int32, device=device)
    if t.ndim == 0:
        return t.expand(batch)
    return t


def _row_window(buf: torch.Tensor, start: torch.Tensor, n: int):
    """Index tensors of the n-long window at start[b] of every row b of buf
    (B, N, ...), the start clamped to [0, N - n] like
    dynamic_update_slice."""
    B, N = buf.shape[:2]
    start = start.to(torch.long).clamp(0, N - n)
    rows = torch.arange(B, device=buf.device)[:, None]
    return rows, start[:, None] + torch.arange(n, device=buf.device)


def _row_update_(buf: torch.Tensor, new: torch.Tensor,
                 start: torch.Tensor) -> None:
    """In place: row b of buf (B, N, ...) gets new[b] (n, ...) at
    start[b]."""
    rows, idx = _row_window(buf, start, new.shape[1])
    buf[rows, idx] = new.to(buf.dtype)


def compressed_cache_spec(
    *, num_layers: int, batch: int, max_seq: int, block_size: int,
    block_slots: int, num_kv_heads: int, head_dim: int,
    dtype=torch.bfloat16,
) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{leaf: (shape, dtype)} of the compressed cache."""
    M = (max_seq // block_size) * block_slots
    kv = lambda *s: (s, dtype)  # noqa: E731
    return {
        "raw_k": kv(num_layers, batch, block_size, num_kv_heads, head_dim),
        "raw_v": kv(num_layers, batch, block_size, num_kv_heads, head_dim),
        "comp_k": kv(num_layers, batch, M, num_kv_heads, head_dim),
        "comp_v": kv(num_layers, batch, M, num_kv_heads, head_dim),
        "lengths": ((batch,), torch.int32),
    }


def init_compressed_cache(*, device: torch.device, **kw
                          ) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in compressed_cache_spec(**kw).items()}


def compressed_decode_attention(
    q_t: torch.Tensor,           # (B, 1, H, Dh) — rope already applied
    k_t: torch.Tensor,           # (B, 1, Hkv, Dh)
    v_t: torch.Tensor,
    layer_cache: Dict[str, torch.Tensor],   # raw_k (B,c,Hkv,Dh), comp_k (B,M,Hkv,Dh)
    E: torch.Tensor,             # (c, r) or (Hkv, c, r)
    F: torch.Tensor,
    t,                           # () or (B,) int32 — tokens already cached
    *,
    scale: Optional[float] = None,
    plan=None,                   # AttentionPlan | backend string | None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step of blockwise-causal Linformer attention.

    Writes (k_t, v_t) at each row's ring position t[b] mod c, attends
    [ring ≤ pos[b] | compressed slots of completed blocks], and folds a
    row's block into its r compressed slots when t[b] completes it. The
    layer cache is updated in place and returned. The attention math
    dispatches through `plan` (parallel/plan.py)."""
    from repro_torch.parallel.plan import as_plan
    plan = as_plan(plan)
    raw_k, raw_v = layer_cache["raw_k"], layer_cache["raw_v"]
    comp_k, comp_v = layer_cache["comp_k"], layer_cache["comp_v"]
    B, c, Hkv, Dh = raw_k.shape
    M = comp_k.shape[1]
    r = E.shape[-1]
    scale_ = scale if scale is not None else Dh ** -0.5

    t = rowwise_t(t, B, raw_k.device)
    pos = torch.remainder(t, c)                  # (B,)
    blk = torch.div(t, c, rounding_mode="floor")

    _row_update_(raw_k, k_t, pos)
    _row_update_(raw_v, v_t, pos)

    loc_ok = torch.arange(c, device=t.device)[None, :] <= pos[:, None]
    glob_ok = torch.arange(M, device=t.device)[None, :] < (blk * r)[:, None]
    out = plan.decode_attention(q_t, raw_k, raw_v, comp_k, comp_v,
                                loc_ok, glob_ok, scale=scale_)

    # Fold a row's block into its slots when it completes (pos == c-1):
    # computed for every row (tiny) and committed per row by a select, so
    # no host sync decides which rows fold.
    eq = "bchd,cr->brhd" if E.ndim == 2 else "bchd,hcr->brhd"
    new_ks = torch.einsum(eq, raw_k, E.to(raw_k.dtype))
    new_vs = torch.einsum(eq, raw_v, F.to(raw_v.dtype))
    done = (pos == (c - 1))[:, None, None, None]
    rows, idx = _row_window(comp_k, blk * r, r)
    comp_k[rows, idx] = torch.where(done, new_ks.to(comp_k.dtype),
                                    comp_k[rows, idx])
    comp_v[rows, idx] = torch.where(done, new_vs.to(comp_v.dtype),
                                    comp_v[rows, idx])
    return out, layer_cache


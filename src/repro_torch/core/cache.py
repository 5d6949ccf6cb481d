"""Decode-time caches: the Linformer-causal compressed cache, its paged,
quantized sibling, and the standard-attention baseline's full KV cache.

Counterpart of ``repro/core/cache.py``. Per
layer the cache holds (a) a raw ring buffer for the current, incomplete
block of K/V and (b) r compressed slots per completed block. A context of
length n costs c + r·⌊n/c⌋ slots instead of n.

Chunked prefill: :func:`compressed_prefill_chunk` and
:func:`paged_prefill_chunk` commit one P-token prefill chunk per row at the
row's own offset; every chunk boundary is a block-fold boundary, so chunks
fold straight into compressed slots (or pages) and the ring is untouched.

Caches are plain dicts of tensors with the layer axis leading:
``raw_k``/``raw_v`` (L, B, c, Hkv, Dh), ``comp_k``/``comp_v``
(L, B, M, Hkv, Dh) with M = (max_seq/c)·r, and ``lengths`` (B,) int32, one
position counter per batch row: rows of a continuous batch sit at unequal
positions, and every mask, ring write and block fold is per row.

The full cache (:func:`init_full_cache`) holds every position's K/V,
``k``/``v`` (L, B, max_seq, Hkv, Dh), and the same ``lengths``: the paper's
softmax baseline, which Table 3 times against the compressed forms.

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

from repro_torch.core.causal import compress_blocks, masked_softmax


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


def local_kv(plan, cache_heads: int, k, v, E, F):
    """k, v (..., Hkv, Dh) and per-head E/F (Hkv, c, r) cut to this rank's
    heads when the plan lays its pool out over tp (plan.shards_cache; the
    pool then holds `cache_heads` of them, per the plan's cache_pspecs);
    a plan held to this rank's heads takes k and v as they are."""
    k, v = plan.kv_shard(k, 2), plan.kv_shard(v, 2)
    if E.ndim == 3:
        E, F = plan.head_shard(E, 0), plan.head_shard(F, 0)
    if k.shape[2] != cache_heads:
        raise ValueError(f"the cache holds {cache_heads} KV heads where "
                         f"the plan's layout gives {k.shape[2]}: lay the "
                         f"pool out with plan.place_cache")
    return k, v, E, F


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
    k_t, v_t, E, F = local_kv(plan, Hkv, k_t, v_t, E, F)
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



def compressed_prefill_chunk(
    q: torch.Tensor,             # (B, P, H, Dh) — one prefill chunk, rope applied
    k: torch.Tensor,             # (B, P, Hkv, Dh)
    v: torch.Tensor,
    layer_cache: Dict[str, torch.Tensor],
    E: torch.Tensor,             # (c, r) or (Hkv, c, r)
    F: torch.Tensor,
    t0,                          # (B,) int32 — row's current length, multiple of c
    *,
    scale: Optional[float] = None,
    plan=None,                   # AttentionPlan | backend string | None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One chunked-prefill step of blockwise-causal Linformer attention.

    Row b's chunk covers absolute positions [t0[b], t0[b] + P); t0 and P are
    multiples of c, so the chunk's P/c blocks fold straight into r slots
    each, written in place at slot offset (t0[b] // c)·r; the raw ring is
    untouched (remainder tokens go through the decode path). Attention then
    reads the updated slot buffer: [own block, causal | slots of absolute
    blocks < t0//c + j], the monolithic prefill's math when the cache dtype
    is the activation dtype. Rows padded with whole garbage blocks write
    garbage slots past their valid blocks; those are never visible and are
    overwritten before visibility reaches them.

    Returns (out (B, P, H, Dh), the layer cache, updated in place)."""
    from repro_torch.parallel.plan import as_plan
    plan = as_plan(plan)
    comp_k, comp_v = layer_cache["comp_k"], layer_cache["comp_v"]
    k, v, E, F = local_kv(plan, comp_k.shape[2], k, v, E, F)
    B, P, Hkv, Dh = k.shape
    c = layer_cache["raw_k"].shape[1]
    r = E.shape[-1]
    scale_ = scale if scale is not None else q.shape[-1] ** -0.5
    if P % c != 0:
        raise ValueError(f"prefill chunk P={P} not a multiple of block {c}")
    nb = P // c

    kbar = compress_blocks(k.reshape(B, nb, c, Hkv, Dh), E)
    vbar = compress_blocks(v.reshape(B, nb, c, Hkv, Dh), F)
    t0 = rowwise_t(t0, B, k.device)
    start_blocks = torch.div(t0, c, rounding_mode="floor")
    _row_update_(comp_k, kbar.reshape(B, nb * r, Hkv, Dh), start_blocks * r)
    _row_update_(comp_v, vbar.reshape(B, nb * r, Hkv, Dh), start_blocks * r)

    out = plan.chunk_prefill_attention(
        q, k, v, comp_k, comp_v, start_blocks, block_size=c, block_slots=r,
        scale=scale_)
    return out, layer_cache


# ---------------------------------------------------------------------------
# Paged, quantized (Linformer-causal) cache
# ---------------------------------------------------------------------------
#
# Same attention math as the compressed cache, different storage:
#
# * the raw ring is stored quantized (int8, or fp8 e4m3) with one fp32 scale
#   per cached token per KV head (symmetric, amax over Dh);
# * the compressed slots live in a shared PAGE ARENA: one page holds the r
#   slots of one completed block, quantized with one fp32 scale per page per
#   KV head (amax over r·Dh);
# * a per-row page table (B, max_pages) int32 maps a row's block index to an
#   arena page; -1 = unallocated. Pages are allocated on the host
#   (serving/paged.PageAllocator) between chunks. A fold whose table entry
#   is unallocated, or whose block index is out of range, goes to the
#   reserved TRASH page (the last one), which is never read.
#
# The page_table leaf carries a leading layer axis like every other leaf
# (identical rows), so per-layer slicing treats all leaves alike.


def resolve_page_dtype(name: str = "int8") -> Tuple[torch.dtype, float]:
    """Map a page-dtype name to (torch dtype, symmetric qmax)."""
    if name == "int8":
        return torch.int8, 127.0
    if name == "fp8":
        fp8 = getattr(torch, "float8_e4m3fn", None)
        if fp8 is None:
            raise ValueError("fp8 page dtype requires torch.float8_e4m3fn")
        return fp8, 448.0
    raise ValueError(f"unknown page dtype {name!r} (expected int8|fp8)")


def _qmax_for(dtype: torch.dtype) -> float:
    return 127.0 if dtype == torch.int8 else 448.0


def quantize_blockwise(x: torch.Tensor, axes, *, dtype=torch.int8,
                       qmax: float = 127.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block quantization: ``scale = max(amax, eps)/qmax``
    over the reduced ``axes`` (fp32 math), values rounded (half to even)
    and clipped for int8, clipped only for fp8 (whose cast rounds to
    nearest even). Returns (codes, scale) with the reduced axes squeezed
    out of ``scale``."""
    axes = tuple(axes)
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=axes, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / qmax
    q = xf / scale
    if dtype.is_floating_point:
        q = torch.clamp(q, -qmax, qmax)
    else:
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return q.to(dtype), scale.squeeze(axes)


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor
                         ) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise` for the cache layouts here, in
    fp32: ``scale`` broadcasts against ``q`` once a trailing Dh axis is
    appended (model layout (…, N, Hkv, Dh) with (…, N, Hkv) scales, or
    kernel layout (B, Hkv, N, Dh) with (B, Hkv, N))."""
    return q.to(torch.float32) * scale[..., None]


def paged_cache_spec(
    *, num_layers: int, batch: int, max_seq: int, block_size: int,
    block_slots: int, num_kv_heads: int, head_dim: int,
    arena_pages: Optional[int] = None, page_dtype: str = "int8",
) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{leaf: (shape, dtype)} of the paged, quantized cache.
    ``arena_pages`` defaults to one full table per row plus the TRASH page
    (capacity-equivalent to the dense pool); the last page is always
    TRASH."""
    maxp = max_seq // block_size
    if arena_pages is None:
        arena_pages = batch * maxp + 1
    if arena_pages < 2:
        raise ValueError("arena_pages must be >= 2 (1 usable + TRASH)")
    pdt, _ = resolve_page_dtype(page_dtype)
    L, B, c, r = num_layers, batch, block_size, block_slots
    Hkv, Dh, Np = num_kv_heads, head_dim, arena_pages
    f32, i32 = torch.float32, torch.int32
    return {
        "raw_k_q": ((L, B, c, Hkv, Dh), pdt),
        "raw_v_q": ((L, B, c, Hkv, Dh), pdt),
        "raw_k_s": ((L, B, c, Hkv), f32),
        "raw_v_s": ((L, B, c, Hkv), f32),
        "page_k": ((L, Np, r, Hkv, Dh), pdt),
        "page_v": ((L, Np, r, Hkv, Dh), pdt),
        "page_k_s": ((L, Np, Hkv), f32),
        "page_v_s": ((L, Np, Hkv), f32),
        "page_table": ((L, B, maxp), i32),
        "lengths": ((B,), i32),
    }


def init_paged_cache(*, device: torch.device, **kw
                     ) -> Dict[str, torch.Tensor]:
    """Zeroed paged cache; the page table starts all-unallocated (-1), not
    zero: page 0 is a real arena page."""
    out = {}
    for k, (shape, dt) in paged_cache_spec(**kw).items():
        fill = -1 if k == "page_table" else 0
        out[k] = torch.full(shape, fill, dtype=dt, device=device) \
            if fill else torch.zeros(shape, dtype=dt, device=device)
    return out


def paged_gather(page_q: torch.Tensor, page_s: torch.Tensor,
                 page_table: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A row-major dense (B, M, Hkv, Dh) quantized slot view plus per-slot
    scales (B, M, Hkv), gathered from the page arena through the page
    table. Unallocated entries (-1) read page 0's bytes; those slots are
    never visible (visibility stops at the row's completed blocks)."""
    B, maxp = page_table.shape
    Np, r, Hkv, Dh = page_q.shape
    idx = page_table.clamp(0, Np - 1).long()
    gq = page_q[idx].reshape(B, maxp * r, Hkv, Dh)
    gs = page_s[idx].repeat_interleave(r, dim=1)          # (B, maxp·r, Hkv)
    return gq, gs


def _paged_leaves(layer_cache):
    return tuple(layer_cache[k] for k in (
        "raw_k_q", "raw_v_q", "raw_k_s", "raw_v_s", "page_k", "page_v",
        "page_k_s", "page_v_s", "page_table"))


def last_writes(dst: torch.Tensor, trash: int) -> torch.Tensor:
    """Page ids `dst` (N,) of a batched arena write, each page but TRASH
    kept only at its last position and the earlier writes sent to TRASH:
    the write is then deterministic with JAX's outcome (its scatter lands
    the last of duplicate indices) where rows repeat, as the padding rows
    of a batched admission do; under MoE their pages differ."""
    later = torch.triu(dst[:, None] == dst[None, :], diagonal=1).any(1)
    return dst.masked_fill(later, trash)


def paged_decode_attention(
    q_t: torch.Tensor,           # (B, 1, H, Dh) — rope already applied at pos t
    k_t: torch.Tensor,           # (B, 1, Hkv, Dh)
    v_t: torch.Tensor,
    layer_cache: Dict[str, torch.Tensor],
    E: torch.Tensor,             # (c, r) or (Hkv, c, r)
    F: torch.Tensor,
    t,                           # () or (B,) int32 — tokens already cached per row
    *,
    scale: Optional[float] = None,
    plan=None,                   # AttentionPlan | backend string | None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step over the paged, quantized cache, in place.

    The bookkeeping of :func:`compressed_decode_attention` with three
    storage differences: (a) the incoming token is quantized per (row,
    head) into the int8/fp8 ring beside its scale; (b) attention reads a
    dense gather of the page arena (dequantised inside the kernel on the
    kernel route); (c) a completed block's fold is computed from the
    dequantised ring, re-quantized per (row, head) over (r, Dh) and
    scattered to the row's table page; rows that did not complete a block,
    or whose block has no page, scatter to TRASH instead."""
    from repro_torch.parallel.plan import as_plan
    plan = as_plan(plan)
    rk_q, rv_q, rk_s, rv_s, pk, pv, pk_s, pv_s, pt = \
        _paged_leaves(layer_cache)
    B, c, Hkv, Dh = rk_q.shape
    k_t, v_t, E, F = local_kv(plan, Hkv, k_t, v_t, E, F)
    Np, r = pk.shape[0], pk.shape[1]
    maxp = pt.shape[1]
    M = maxp * r
    qmax = _qmax_for(pk.dtype)
    trash = Np - 1
    scale_ = scale if scale is not None else Dh ** -0.5

    t = rowwise_t(t, B, rk_q.device)
    pos = torch.remainder(t, c)
    blk = torch.div(t, c, rounding_mode="floor")

    for ring, ring_s, x in ((rk_q, rk_s, k_t), (rv_q, rv_s, v_t)):
        x_q, x_s = quantize_blockwise(x, (3,), dtype=pk.dtype, qmax=qmax)
        _row_update_(ring, x_q, pos)
        _row_update_(ring_s, x_s, pos)

    gk, gk_s = paged_gather(pk, pk_s, pt)
    gv, gv_s = paged_gather(pv, pv_s, pt)
    loc_ok = torch.arange(c, device=t.device)[None, :] <= pos[:, None]
    glob_ok = torch.arange(M, device=t.device)[None, :] < (blk * r)[:, None]
    out = plan.decode_attention_q(q_t, rk_q, rv_q, rk_s, rv_s, gk, gv, gk_s,
                                  gv_s, loc_ok, glob_ok, scale=scale_)

    # fold: dequantize the ring, compress, re-quantize per (row, head) over
    # (r, Dh), scatter to the row's page, or to TRASH
    eq = "bchd,cr->brhd" if E.ndim == 2 else "bchd,hcr->brhd"
    pt_blk = pt.gather(1, blk.clamp(0, maxp - 1).long()[:, None])[:, 0]
    commit = (pos == c - 1) & (pt_blk >= 0) & (blk < maxp)
    dst = last_writes(torch.where(commit, pt_blk,
                                  torch.full_like(pt_blk, trash)).long(),
                      trash)
    for ring, ring_s, W, page, page_s in ((rk_q, rk_s, E, pk, pk_s),
                                          (rv_q, rv_s, F, pv, pv_s)):
        folded = torch.einsum(eq, dequantize_blockwise(ring, ring_s),
                              W.to(torch.float32))
        f_q, f_s = quantize_blockwise(folded, (1, 3), dtype=pk.dtype,
                                      qmax=qmax)
        page[dst] = f_q
        page_s[dst] = f_s
    return out, layer_cache


def paged_prefill_chunk(
    q: torch.Tensor,             # (B, P, H, Dh) — one prefill chunk, rope applied
    k: torch.Tensor,             # (B, P, Hkv, Dh)
    v: torch.Tensor,
    layer_cache: Dict[str, torch.Tensor],
    E: torch.Tensor,             # (c, r) or (Hkv, c, r)
    F: torch.Tensor,
    t0,                          # (B,) int32 — row's current length, multiple of c
    *,
    scale: Optional[float] = None,
    plan=None,                   # AttentionPlan | backend string | None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One chunked-prefill step over the paged, quantized cache, in place.

    The chunk's P/c block folds are quantized per (row, block, head) and
    scattered to the row's table pages (unallocated or out-of-range blocks,
    padded prefill garbage, go to TRASH). Attention then reads the gather
    of the arena taken after the scatter, so a chunk's own earlier blocks
    are visible cache-rounded. The raw ring is untouched."""
    from repro_torch.parallel.plan import as_plan
    plan = as_plan(plan)
    _, _, _, _, pk, pv, pk_s, pv_s, pt = _paged_leaves(layer_cache)
    k, v, E, F = local_kv(plan, pk.shape[2], k, v, E, F)
    B, P, Hkv, Dh = k.shape
    c = layer_cache["raw_k_q"].shape[1]
    r = E.shape[-1]
    Np = pk.shape[0]
    maxp = pt.shape[1]
    qmax = _qmax_for(pk.dtype)
    trash = Np - 1
    scale_ = scale if scale is not None else q.shape[-1] ** -0.5
    if P % c != 0:
        raise ValueError(f"prefill chunk P={P} not a multiple of block {c}")
    nb = P // c

    t0 = rowwise_t(t0, B, k.device)
    blk0 = torch.div(t0, c, rounding_mode="floor")
    abs_blk = blk0[:, None] + torch.arange(nb, device=k.device)[None, :]
    pids = pt.gather(1, abs_blk.clamp(0, maxp - 1).long())
    dst = last_writes(torch.where((pids >= 0) & (abs_blk < maxp), pids,
                                  torch.full_like(pids, trash)
                                  ).reshape(-1).long(), trash)
    for x, W, page, page_s in ((k, E, pk, pk_s), (v, F, pv, pv_s)):
        xbar = compress_blocks(
            x.to(torch.float32).reshape(B, nb, c, Hkv, Dh),
            W.to(torch.float32))                      # (B, nb, r, Hkv, Dh)
        b_q, b_s = quantize_blockwise(xbar, (2, 4), dtype=pk.dtype,
                                      qmax=qmax)
        page[dst] = b_q.reshape(B * nb, r, Hkv, Dh)
        page_s[dst] = b_s.reshape(B * nb, Hkv)

    gk, gk_s = paged_gather(pk, pk_s, pt)
    gv, gv_s = paged_gather(pv, pv_s, pt)
    out = plan.chunk_prefill_attention_q(
        q, k, v, gk, gv, gk_s, gv_s, blk0, block_size=c, block_slots=r,
        scale=scale_)
    return out, layer_cache


# ---------------------------------------------------------------------------
# Full KV cache (the standard-attention baseline)
# ---------------------------------------------------------------------------


def full_cache_spec(
    *, num_layers: int, batch: int, max_seq: int, num_kv_heads: int,
    head_dim: int, dtype=torch.bfloat16,
) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{leaf: (shape, dtype)} of the full cache."""
    kv = (num_layers, batch, max_seq, num_kv_heads, head_dim)
    return {"k": (kv, dtype), "v": (kv, dtype),
            "lengths": ((batch,), torch.int32)}


def init_full_cache(*, device: torch.device, **kw) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in full_cache_spec(**kw).items()}


def full_decode_attention(
    q_t: torch.Tensor,           # (B, 1, H, Dh) — rope already applied
    k_t: torch.Tensor,           # (B, 1, Hkv, Dh)
    v_t: torch.Tensor,
    layer_cache: Dict[str, torch.Tensor],   # k/v: (B, S, Hkv, Dh)
    t,                           # () or (B,) int32 per-row positions
    *,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step of standard causal attention over the full cache:
    row b writes (k_t, v_t) at t[b] (clamped like dynamic_update_slice) and
    attends positions <= t[b]. The cache is updated in place and
    returned."""
    ck, cv = layer_cache["k"], layer_cache["v"]
    B, S, Hkv, Dh = ck.shape
    H = q_t.shape[2]
    scale_ = scale if scale is not None else Dh ** -0.5
    t = rowwise_t(t, B, ck.device)
    _row_update_(ck, k_t, t)
    _row_update_(cv, v_t, t)
    G = H // Hkv
    dt = torch.promote_types(q_t.dtype, ck.dtype)   # as JAX's einsum
    qg, ck_, cv_ = q_t.reshape(B, Hkv, G, Dh).to(dt), ck.to(dt), cv.to(dt)
    # the cache is read in place, as (B, S, Hkv·Dh) matrices: the scores are
    # one product of a block-diagonal q (query head h·G + g holds q in kv
    # head h's Dh columns, zeros elsewhere; exact) with the transposed
    # cache, where an einsum over (b, h) would first copy the cache into
    # (B, Hkv, S, Dh); the value product gives every head against every kv
    # head and keeps the diagonal
    qbd = qg.new_zeros(B, Hkv, G, Hkv, Dh)
    qbd.diagonal(dim1=1, dim2=3).copy_(qg.permute(0, 2, 3, 1))
    ck_, cv_ = ck_.reshape(B, S, Hkv * Dh), cv_.reshape(B, S, Hkv * Dh)
    s = qbd.reshape(B, H, Hkv * Dh) @ ck_.transpose(1, 2)          # (B,H,S)
    ok = torch.arange(S, device=ck.device)[None, :] <= t[:, None]   # (B, S)
    p = masked_softmax(s, ok[:, None, :], scale_, q_t.dtype)
    pv = p.to(cv_.dtype) @ cv_                                  # (B,H,Hkv·Dh)
    out = pv.view(B, Hkv, G, Hkv, Dh).diagonal(dim1=1, dim2=3)  # (B,G,Dh,Hkv)
    return out.permute(0, 3, 1, 2).reshape(B, 1, H, Dh), layer_cache


def full_prefill_chunk(
    q: torch.Tensor,             # (B, P, H, Dh) — rope applied
    k: torch.Tensor,             # (B, P, Hkv, Dh)
    v: torch.Tensor,
    layer_cache: Dict[str, torch.Tensor],   # k/v: (B, S, Hkv, Dh)
    t0,                          # (B,) int32 — row's current length
    *,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One chunked-prefill step of standard causal attention over the full
    cache, in place: row b's chunk is written at [t0[b], t0[b] + P) (the
    start clamped to S - P like dynamic_update_slice) and query i attends
    positions <= t0[b] + i. Padded tail tokens write garbage that the
    decode path overwrites position by position before its mask reaches
    them."""
    ck, cv = layer_cache["k"], layer_cache["v"]
    B, S, Hkv, Dh = ck.shape
    P, H = q.shape[1], q.shape[2]
    scale_ = scale if scale is not None else Dh ** -0.5
    t0 = rowwise_t(t0, B, ck.device)
    _row_update_(ck, k, t0)
    _row_update_(cv, v, t0)
    qg = q.reshape(B, P, Hkv, H // Hkv, Dh)
    qpos = t0[:, None] + torch.arange(P, device=ck.device)[None, :]
    ok = torch.arange(S, device=ck.device)[None, None, :] \
        <= qpos[:, :, None]                                      # (B, P, S)
    dt = torch.promote_types(q.dtype, ck.dtype)     # as JAX's einsum
    qg_, ck_, cv_ = qg.to(dt), ck.to(dt), cv.to(dt)
    p = masked_softmax(torch.einsum("bphgd,bshd->bhgps", qg_, ck_),
                       ok[:, None, None], scale_, q.dtype)
    out = torch.einsum("bhgps,bshd->bphgd", p.to(cv_.dtype), cv_)
    return out.reshape(B, P, H, Dh), layer_cache

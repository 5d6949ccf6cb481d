"""Blockwise-causal Linformer attention: the plain PyTorch reference forms.

Counterpart of ``repro/core/causal.py``. The convolutional projection
(kernel = stride = c) compresses each c-token block into r slots, so a query
at position t (block n = t // c) attends

  * exactly and causally within its own block (positions n·c .. t), and
  * the r compressed slots of every block strictly before n.

These functions are the parity oracle of the port (``backend="reference"``)
and mirror the JAX reference einsum for einsum, cast point for cast point:
scores in fp32, masks as ``NEG_INF`` on the fp32 scores (never ``-inf``, so
a row whose every entry is masked stays finite), softmax output cast to the
query dtype before the value product. :func:`masked_softmax` is that policy
for one score tensor; the standard softmax baseline (models/attention.py,
the full cache in core/cache.py) takes its p from it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.tune import table as tuning

NEG_INF = -1e30

# Sequences at or above this length route the reference attention (the
# plain forward route and the plain backward route of kernels/ops.py)
# through the memory-bounded chunked form instead of the plain form, whose
# (S × nb·r) global score tensor would be materialised whole. The JAX
# package's value; the tuning table's ``chunked_min_seq`` scalar overrides it
# per platform.
CHUNKED_ATTENTION_MIN_SEQ = 8192


def chunked_attention_min_seq(platform: Optional[str] = None) -> int:
    """The chunked-against-plain routing threshold, after tuning: the
    table's platform-wide ``chunked_min_seq`` scalar for `platform` (a
    `tune.table.platform_key`; None: the card when there is one), else
    CHUNKED_ATTENTION_MIN_SEQ."""
    return tuning.scalar("chunked_min_seq", CHUNKED_ATTENTION_MIN_SEQ,
                         platform=platform)


def _common(*xs: torch.Tensor):
    """Cast operands to their promoted dtype (JAX promotes mixed operands of
    an einsum implicitly; torch.einsum requires one dtype)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def masked_softmax(s: torch.Tensor, ok: Optional[torch.Tensor],
                   scale: float, dtype: torch.dtype,
                   dim: int = -1) -> torch.Tensor:
    """p from the raw scores `s` at the cast points above: s (a score
    einsum's output in its operands' dtype, so bf16 scores are rounded
    once) cast to fp32 and scaled, NEG_INF where the boolean `ok`
    (broadcast to s; None: no mask) is False, softmax in fp32 along `dim`,
    p cast to `dtype`. Works on s in place (autograd saves no tensor these
    ops overwrite): pass the einsum's output and keep no reference to it,
    and no second fp32 buffer of its size is live."""
    s = s.to(torch.float32)
    s.mul_(scale)
    if ok is not None:
        s.masked_fill_(~ok, NEG_INF)
    return torch.softmax(s, dim=dim).to(dtype)


def compress_blocks(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """(B, nb, c, Hkv, Dh) × (c, r)|(Hkv, c, r) -> (B, nb, r, Hkv, Dh)."""
    if W.ndim == 2:
        return torch.einsum("bnchd,cr->bnrhd", x, W.to(x.dtype))
    return torch.einsum("bnchd,hcr->bnrhd", x, W.to(x.dtype))


def blockwise_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    E: torch.Tensor,
    F: torch.Tensor,
    *,
    block_size: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Training/prefill-parallel form.

    q: (B,S,H,Dh); k,v: (B,S,Hkv,Dh); E,F: (c,r) or (Hkv,c,r); S % c == 0.
    Returns (B,S,H,Dh). Materializes the (…, S, c + nb·r) joint score
    tensor: fine at serving prefill lengths; long sequences take
    :func:`blockwise_causal_attention_chunked`."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    c = block_size
    if S % c != 0:
        raise ValueError(f"S={S} must be a multiple of block_size={c}")
    nb = S // c
    r = E.shape[-1]
    scale = scale if scale is not None else Dh ** -0.5

    kb = k.reshape(B, nb, c, Hkv, Dh)
    vb = v.reshape(B, nb, c, Hkv, Dh)
    qb = q.reshape(B, nb, c, Hkv, G, Dh)

    kbar = compress_blocks(kb, E)                       # (B,nb,r,Hkv,Dh)
    vbar = compress_blocks(vb, F)

    # local: exact causal attention within each block
    s_loc = torch.einsum("bnchgd,bnkhd->bhgnck", qb, kb).float() * scale
    causal = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    s_loc = s_loc.masked_fill(~causal, NEG_INF)

    # global: compressed slots of strictly-previous blocks
    s_glob = torch.einsum("bnchgd,bmrhd->bhgncmr", qb, kbar).float() * scale
    blk = torch.arange(nb, device=q.device)
    blk_vis = blk[:, None] > blk[None, :]               # (n_q, m_kv)
    s_glob = s_glob.masked_fill(~blk_vis[:, None, :, None], NEG_INF)
    s_glob = s_glob.reshape(*s_glob.shape[:-2], nb * r)

    # joint softmax over [own block | compressed prefix]
    s = torch.cat([s_loc, s_glob], dim=-1)              # (B,Hkv,G,nb,c,c+nb*r)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    p_loc, p_glob = p[..., :c], p[..., c:]

    out = torch.einsum("bhgnck,bnkhd->bnchgd", p_loc, vb)
    vbar_flat = vbar.reshape(B, nb * r, Hkv, Dh)
    out = out + torch.einsum("bhgncm,bmhd->bnchgd", p_glob, vbar_flat)
    return out.reshape(B, S, H, Dh)


def blockwise_causal_prefix_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    comp_k: torch.Tensor,
    comp_v: torch.Tensor,
    start_blocks,
    *,
    block_size: int,
    block_slots: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Chunked-prefill form: a chunk of queries at a per-row block offset
    attends [own block, causal | slot-resident compressed prefix].

    q: (B, P, H, Dh), one prefill chunk (P % block_size == 0) whose row b
    starts at absolute position start_blocks[b]·c; k, v: (B, P, Hkv, Dh) the
    chunk's own keys/values; comp_k, comp_v: (B, M, Hkv, Dh) the cache's
    slot buffers with the chunk's own blocks already folded in at slot
    offset start_blocks·r. A query in chunk block j sees the slots m with
    m // r < start_blocks[b] + j. Identical math to
    :func:`blockwise_causal_attention` restricted to the chunk's rows. Query
    blocks run one at a time, so the (P × M) global score tensor is never
    materialised whole."""
    B, P, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    c = block_size
    if P % c != 0:
        raise ValueError(f"chunk P={P} must be a multiple of block_size={c}")
    nb = P // c
    r = block_slots
    M = comp_k.shape[1]
    scale_ = scale if scale is not None else Dh ** -0.5
    start = torch.as_tensor(start_blocks, device=q.device).to(torch.long)
    start = start.expand(B) if start.ndim == 0 else start

    qb = q.reshape(B, nb, c, Hkv, G, Dh)
    kb = k.reshape(B, nb, c, Hkv, Dh)
    vb = v.reshape(B, nb, c, Hkv, Dh)
    causal = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    slot_blk = torch.arange(M, device=q.device) // r     # owning block

    outs = []
    for j in range(nb):
        qi, ki, vi = qb[:, j], kb[:, j], vb[:, j]        # qi: (B,c,Hkv,G,Dh)
        a, b_ = _common(qi, ki)
        s_loc = torch.einsum("bchgd,bkhd->bhgck", a, b_).float() * scale_
        s_loc = s_loc.masked_fill(~causal, NEG_INF)
        a, b_ = _common(qi, comp_k)
        s_glob = torch.einsum("bchgd,bmhd->bhgcm", a, b_).float() * scale_
        vis = slot_blk[None, :] < (start + j)[:, None]   # (B, M)
        s_glob = s_glob.masked_fill(~vis[:, None, None, None, :], NEG_INF)
        s = torch.cat([s_loc, s_glob], dim=-1)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        a, b_ = _common(p[..., :c], vi)
        out = torch.einsum("bhgck,bkhd->bchgd", a, b_)
        a, b_ = _common(p[..., c:], comp_v)
        outs.append(out + torch.einsum("bhgcm,bmhd->bchgd", a, b_))
    return torch.stack(outs, dim=1).reshape(B, P, H, Dh)


def masked_decode_attention(
    q_t: torch.Tensor,        # (B, 1, H, Dh)
    raw_k: torch.Tensor,      # (B, c, Hkv, Dh) — raw ring buffer
    raw_v: torch.Tensor,
    comp_k: torch.Tensor,     # (B, M, Hkv, Dh) — compressed slots
    comp_v: torch.Tensor,
    loc_ok: torch.Tensor,     # (B, c) bool — attendable ring positions
    glob_ok: torch.Tensor,    # (B, M) bool — attendable compressed slots
    *,
    scale: float,
) -> torch.Tensor:
    """Reference single-token decode attention over [raw ring | compressed
    slots] with per-row validity masks. Pure attention math: ring writes
    and block folds live in core/cache.py, dispatch in parallel/plan.py."""
    B, c, Hkv, Dh = raw_k.shape
    H = q_t.shape[2]
    G = H // Hkv
    qg = q_t.reshape(B, Hkv, G, Dh)
    qk, rk = _common(qg, raw_k)
    s_loc = torch.einsum("bhgd,bkhd->bhgk", qk, rk).float() * scale
    s_loc = s_loc.masked_fill(~loc_ok[:, None, None, :], NEG_INF)
    qk, ck = _common(qg, comp_k)
    s_glob = torch.einsum("bhgd,bmhd->bhgm", qk, ck).float() * scale
    s_glob = s_glob.masked_fill(~glob_ok[:, None, None, :], NEG_INF)

    s = torch.cat([s_loc, s_glob], dim=-1)
    p = torch.softmax(s, dim=-1).to(q_t.dtype)
    p_loc, rv = _common(p[..., :c], raw_v)
    out = torch.einsum("bhgk,bkhd->bhgd", p_loc, rv)
    p_glob, cv = _common(p[..., c:], comp_v)
    out = out + torch.einsum("bhgm,bmhd->bhgd", p_glob, cv)
    return out.reshape(B, 1, H, Dh)


def blockwise_causal_attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    E: torch.Tensor,
    F: torch.Tensor,
    *,
    block_size: int,
    q_chunk_blocks: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Memory-bounded form of :func:`blockwise_causal_attention`: identical
    math, with the query blocks taken `q_chunk_blocks` at a time (a Python
    loop where the JAX package runs ``lax.map``), so that the forward holds
    one chunk's (… × q_chunk_blocks·c × (c + nb·r)) scores at a time instead
    of the whole (S × nb·r) tensor. A chunk's queries see their own block
    causally and the slots of the blocks strictly before their own; one
    fp32 softmax over [c | nb·r], p cast to q's dtype.

    Under autograd every chunk's p stays alive for the backward (as JAX's
    VJP of ``lax.map`` keeps its residuals), so the bound holds for the
    forward only, not in training.

    ``q_chunk_blocks`` is a performance knob (the math is chunk-invariant).
    Unset, it resolves through the tuning table (form ``causal_chunked``,
    bucketed on seq, for q's device) with a fallback to
    kernels/common.DEFAULT_Q_CHUNK_BLOCKS; a count that does not divide the
    number of blocks falls back to 1, as in the JAX package."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    c = block_size
    if S % c != 0:
        raise ValueError(f"S={S} must be a multiple of block_size={c}")
    nb = S // c
    r = E.shape[-1]
    scale_ = scale if scale is not None else Dh ** -0.5
    if q_chunk_blocks is None:
        q_chunk_blocks = tuning.q_chunk_blocks_for(
            seq=S, platform=tuning.platform_key(q.device))
    if nb % q_chunk_blocks != 0:
        q_chunk_blocks = 1
    n_chunks = nb // q_chunk_blocks

    kb = k.reshape(B, nb, c, Hkv, Dh)
    vb = v.reshape(B, nb, c, Hkv, Dh)
    kbar = compress_blocks(kb, E).reshape(B, nb * r, Hkv, Dh)
    vbar = compress_blocks(vb, F).reshape(B, nb * r, Hkv, Dh)
    qc = q.reshape(B, n_chunks, q_chunk_blocks, c, Hkv, G, Dh)
    kc = kb.reshape(B, n_chunks, q_chunk_blocks, c, Hkv, Dh)
    vc = vb.reshape(B, n_chunks, q_chunk_blocks, c, Hkv, Dh)

    causal = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    slot_blk = torch.arange(nb * r, device=q.device) // r   # owning block
    outs = []
    for ci in range(n_chunks):
        qi, ki, vi = qc[:, ci], kc[:, ci], vc[:, ci]     # qi: (B,qcb,c,Hkv,G,Dh)
        blk_ids = ci * q_chunk_blocks + torch.arange(q_chunk_blocks,
                                                     device=q.device)
        s_loc = torch.einsum("bnchgd,bnkhd->bhgnck", qi, ki).float() * scale_
        s_loc = s_loc.masked_fill(~causal, NEG_INF)
        s_glob = torch.einsum("bnchgd,bmhd->bhgncm", qi,
                              kbar).float() * scale_
        vis = blk_ids[:, None] > slot_blk[None, :]       # (qcb, nb*r)
        s_glob = s_glob.masked_fill(~vis[:, None, :], NEG_INF)
        s = torch.cat([s_loc, s_glob], dim=-1)
        del s_loc, s_glob
        p = torch.softmax(s, dim=-1).to(q.dtype)
        del s
        out = torch.einsum("bhgnck,bnkhd->bnchgd", p[..., :c], vi)
        outs.append(out + torch.einsum("bhgncm,bmhd->bnchgd", p[..., c:],
                                       vbar))
    return torch.stack(outs, dim=1).reshape(B, S, H, Dh)

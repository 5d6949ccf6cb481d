"""Public wrappers of the port's kernels, in model layout.

Counterpart of ``repro/kernels/ops.py`` for the serving path: the
blockwise-causal prefill forward and the single-token decode. Layout moves
are views (kernel layout (B, H, S, Dh) <-> model layout (B, S, H, Dh)); the
kernels take strided operands, so nothing is transposed in memory. A CPU
tensor runs each kernel's plain twin, a CUDA tensor the CUDA kernel.

Forward only: the backward kernel of the blockwise form comes with the
training slice, so a CUDA input that requires grad raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.causal import compress_blocks
from repro_torch.kernels import blockwise_causal_attn as bca
from repro_torch.kernels import linformer_attn as la
from repro_torch.kernels.common import from_kernel_layout, to_kernel_layout


def _compress_kv(x, W, block_size, block_slots):
    """(B, S, Hkv, Dh) × E/F → (B, nb·r, Hkv, Dh) compressed slots."""
    B, S, Hkv, Dh = x.shape
    nb = S // block_size
    xbar = compress_blocks(x.reshape(B, nb, block_size, Hkv, Dh), W)
    return xbar.reshape(B, nb * block_slots, Hkv, Dh)


def fused_blockwise_causal_attention(
    q: torch.Tensor,        # (B, S, H, Dh)
    k: torch.Tensor,        # (B, S, Hkv, Dh)
    v: torch.Tensor,
    E: torch.Tensor,        # (c, r) or (Hkv, c, r)
    F: torch.Tensor,
    *,
    block_size: int,
    block_slots: int,
    scale: float,
) -> torch.Tensor:
    """Causal prefill attention through the blockwise-causal kernel:
    compress k/v into r slots per block, then one joint softmax per query
    row over [own block, causal | slots of earlier blocks]."""
    if q.is_cuda and any(t.requires_grad for t in (q, k, v, E, F)):
        raise NotImplementedError(
            "fused_blockwise_causal_attention is forward-only on CUDA (the "
            "backward kernel comes with the training slice); run under "
            "torch.no_grad() or use backend='reference'")
    S = q.shape[1]
    if S % block_size != 0:
        raise ValueError(
            f"S={S} must be a multiple of block_size={block_size}")
    kbar = _compress_kv(k, E, block_size, block_slots)
    vbar = _compress_kv(v, F, block_size, block_slots)
    out = bca.blockwise_causal_attn(
        to_kernel_layout(q), to_kernel_layout(k), to_kernel_layout(v),
        to_kernel_layout(kbar), to_kernel_layout(vbar),
        block_size=block_size, block_slots=block_slots, scale=scale)
    return from_kernel_layout(out)


def fused_decode_attention(
    q_t: torch.Tensor,        # (B, 1, H, Dh) — one decode token per row
    raw_k: torch.Tensor,      # (B, c, Hkv, Dh) — raw ring buffer
    raw_v: torch.Tensor,
    comp_k: torch.Tensor,     # (B, M, Hkv, Dh) — compressed slots
    comp_v: torch.Tensor,
    bias_loc: torch.Tensor,   # (B, c) fp32 — 0 attendable, NEG_INF masked
    bias_glob: torch.Tensor,  # (B, M) fp32
    *,
    scale: float,
) -> torch.Tensor:
    """Single-token GQA decode attention through the decode kernel. The
    GQA group is folded into the kernel's query axis, q (B, 1, Hkv·G, Dh)
    viewed as (B, Hkv, G, Dh); ring and slots stay two operands, each with
    a per-row additive bias, so one launch serves every per-row
    (position, block) mix of a continuous batch."""
    B, _, H, Dh = q_t.shape
    Hkv = raw_k.shape[2]
    if H % Hkv != 0:
        raise ValueError(f"H={H} query heads not a multiple of Hkv={Hkv}")
    qk = q_t.reshape(B, Hkv, H // Hkv, Dh)
    out = la.decode_attn(
        qk, to_kernel_layout(raw_k), to_kernel_layout(raw_v),
        to_kernel_layout(comp_k), to_kernel_layout(comp_v),
        bias_loc, bias_glob, scale=scale)
    return out.reshape(B, 1, H, Dh)

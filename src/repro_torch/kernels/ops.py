"""Public wrappers of the port's kernels, in model layout.

Counterpart of ``repro/kernels/ops.py``: the blockwise-causal attention
(forward, and trainable through the backward kernel), its prefix form for
chunked prefill (trainable the same way), the single-token decode, the two
quantized-cache siblings of the serving path (decode and chunk prefill over
int8/fp8 codes with fp32 scales, forward only), and the exact form's two
kernels (the attention over K compressed slots and the sequence
projection, trainable through their analytic backwards in plain torch, as
the JAX package's custom VJPs). Layout moves are views (kernel
layout (B, H, S, Dh) <-> model layout (B, S, H, Dh)); the kernels take
strided operands, so nothing is transposed in memory. A CPU tensor runs
each kernel's plain twin, a CUDA tensor the CUDA kernel. The five wrappers
of the causal, chunk-prefill and decode forms refuse more than
``MAX_PINNED_SLOTS`` compressed slots with the JAX package's ValueError,
on CPU and CUDA tensors alike.

Gradients (the JAX package's ``_blockwise_causal_diff``): when an input
requires grad, the blockwise attention runs through
:class:`BlockwiseCausalAttnFn` over (q, k, v, k̄, v̄), whose forward is the
residual-emitting kernel and whose backward is the backward kernel. The
compression k̄ = compress_blocks(k, E) stays outside the Function in plain
torch, so autograd chains dk̄/dv̄ into (dk, dE) and (dv, dF) exactly where the
JAX package chains them through the linear ``compress_blocks`` VJP
(``ops.py:290-299``). ``backward_impl`` picks the route through
``common.BACKWARD_ROUTES``: "fused" is that Function, "reference" is
autograd through the plain reference form of core/causal.py (its chunked
form from the tuned ``chunked_attention_min_seq`` on, as the JAX package's
``_bca_bwd_reference``). The prefix form is differentiable the same way
(the JAX package's ``_chunk_prefill_diff``): :class:`ChunkPrefillAttnFn`
runs the prefix kernel with residuals forward and the backward kernel with
per-row start blocks; its plain route is autograd through
core/causal.blockwise_causal_prefix_attention. The exact
form's :class:`LinformerAttnFn` and :class:`SeqProjectionFn` run kernels 5
and 6 forward; their backwards are the JAX package's ``_lin_bwd`` and
``_sp_bwd`` in plain torch (neither TPU kernel has a backward kernel).
"""
from __future__ import annotations

import torch

from repro_torch.core.causal import (blockwise_causal_attention,
                                     blockwise_causal_attention_chunked,
                                     blockwise_causal_prefix_attention,
                                     chunked_attention_min_seq,
                                     compress_blocks)
from repro_torch.kernels import blockwise_causal_attn as bca
from repro_torch.kernels import linformer_attn as la
from repro_torch.kernels import seq_projection as sp
from repro_torch.kernels.common import (DEFAULT_BLOCK_Q, DEFAULT_BLOCK_S,
                                        backward_route, check_exact_k,
                                        check_pinned_slots, divisor_block,
                                        from_kernel_layout, to_kernel_layout)
from repro_torch.tune.table import platform_key


def _scales_to_kernel_layout(s: torch.Tensor) -> torch.Tensor:
    """(B, N, Hkv) per-token/per-slot scales -> kernel layout (B, Hkv, N),
    a view."""
    return s.movedim(2, 1)


def _start_blocks(start_blocks, q: torch.Tensor) -> torch.Tensor:
    """Per-row start blocks as the kernels take them: (B,) int32 on q's
    device."""
    return torch.as_tensor(start_blocks, device=q.device).to(
        torch.int32).reshape(q.shape[0]).contiguous()


def _forward_only(name: str, *xs: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise NotImplementedError(
            f"{name} is forward-only: the paged cache is a serving "
            "structure, never differentiated through (as in the JAX "
            "package, whose wrapper has no VJP)")


def _compress_kv(x, W, block_size, block_slots):
    """(B, S, Hkv, Dh) × E/F → (B, nb·r, Hkv, Dh) compressed slots, Dh
    contiguous as the kernels take them (einsum may hand back a permuted
    layout: at nb = 1, Dh-strided)."""
    B, S, Hkv, Dh = x.shape
    nb = S // block_size
    xbar = compress_blocks(x.reshape(B, nb, block_size, Hkv, Dh), W)
    xbar = xbar.reshape(B, nb * block_slots, Hkv, Dh)
    return xbar if xbar.stride(-1) == 1 else xbar.contiguous()


class BlockwiseCausalAttnFn(torch.autograd.Function):
    """Differentiable blockwise-causal attention over (q, k, v, k̄, v̄) in
    model layout. The forward runs the residual-emitting kernel and saves
    (q, k, v, k̄, v̄, m, denom); the backward runs the backward kernel and
    returns dq, dk_loc, dv_loc, dk̄, dv̄ cast to their inputs' dtypes (the
    kernel accumulates them in fp32)."""

    @staticmethod
    def forward(ctx, q, k, v, kbar, vbar, block_size, block_slots, scale):
        kw = dict(block_size=block_size, block_slots=block_slots,
                  scale=scale)
        out, m, denom = bca.blockwise_causal_attn(
            to_kernel_layout(q), to_kernel_layout(k), to_kernel_layout(v),
            to_kernel_layout(kbar), to_kernel_layout(vbar),
            return_residuals=True, **kw)
        ctx.save_for_backward(q, k, v, kbar, vbar, m, denom)
        ctx.kw = kw
        return from_kernel_layout(out)

    @staticmethod
    def backward(ctx, do):
        q, k, v, kbar, vbar, m, denom = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        grads = bca.blockwise_causal_attn_bwd(
            to_kernel_layout(q), to_kernel_layout(k), to_kernel_layout(v),
            to_kernel_layout(kbar), to_kernel_layout(vbar), m, denom,
            to_kernel_layout(do), **ctx.kw)
        dq, dk, dv, dkbar, dvbar = (from_kernel_layout(g) for g in grads)
        return (dq, dk.to(k.dtype), dv.to(v.dtype), dkbar.to(kbar.dtype),
                dvbar.to(vbar.dtype), None, None, None)


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
    backward_impl: str = "fused",
) -> torch.Tensor:
    """Causal prefill/training attention through the blockwise-causal
    kernels: compress k/v into r slots per block, then one joint softmax per
    query row over [own block, causal | slots of earlier blocks].

    Trainable: when grad is enabled and an input requires it, the attention
    goes through the route ``backward_impl`` maps to (see the module
    docstring); otherwise it is one launch of the plain forward kernel."""
    S = q.shape[1]
    if S % block_size != 0:
        raise ValueError(
            f"S={S} must be a multiple of block_size={block_size}")
    M = (S // block_size) * block_slots
    check_pinned_slots(
        "fused_blockwise_causal_attention",
        M, f"all M = (S/c)·r = ({S}/{block_size})·{block_slots} = {M} "
        "compressed slots",
        remedy="Raise block_size, lower block_slots, or use "
        "backend='reference' for this shape.")
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, E, F))
    if grad and backward_route(backward_impl) == "plain":
        ref_fn = (blockwise_causal_attention_chunked
                  if S >= chunked_attention_min_seq(platform_key(q.device))
                  else blockwise_causal_attention)
        return ref_fn(q, k, v, E, F, block_size=block_size, scale=scale)
    kbar = _compress_kv(k, E, block_size, block_slots)
    vbar = _compress_kv(v, F, block_size, block_slots)
    if grad:
        return BlockwiseCausalAttnFn.apply(q, k, v, kbar, vbar, block_size,
                                           block_slots, scale)
    out = bca.blockwise_causal_attn(
        to_kernel_layout(q), to_kernel_layout(k), to_kernel_layout(v),
        to_kernel_layout(kbar), to_kernel_layout(vbar),
        block_size=block_size, block_slots=block_slots, scale=scale)
    return from_kernel_layout(out)


class ChunkPrefillAttnFn(torch.autograd.Function):
    """Differentiable prefix-form attention over (q, k, v, comp_k, comp_v)
    in model layout, the start blocks not differentiable (the JAX package's
    ``_cp_fwd``/``_cp_bwd``). The forward runs the prefix kernel with
    residuals and saves (m, denom); the backward runs the backward kernel
    with the per-row start blocks. comp_k and comp_v are independent
    inputs: their cotangent is the raw full-buffer dk̄/dv̄, exact zeros on
    the slots the chunk never sees; chaining it back into k/v (the
    compression, a gather) is the caller's autograd. Every gradient is
    cast to its input's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, comp_k, comp_v, start_blocks, block_size,
                block_slots, scale):
        kw = dict(block_size=block_size, block_slots=block_slots,
                  scale=scale)
        out, m, denom = bca.blockwise_causal_prefix_attn(
            to_kernel_layout(q), to_kernel_layout(k), to_kernel_layout(v),
            to_kernel_layout(comp_k), to_kernel_layout(comp_v), start_blocks,
            return_residuals=True, **kw)
        ctx.save_for_backward(q, k, v, comp_k, comp_v, start_blocks, m,
                              denom)
        ctx.kw = kw
        return from_kernel_layout(out)

    @staticmethod
    def backward(ctx, do):
        q, k, v, comp_k, comp_v, start_blocks, m, denom = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        grads = bca.blockwise_causal_attn_bwd(
            to_kernel_layout(q), to_kernel_layout(k), to_kernel_layout(v),
            to_kernel_layout(comp_k), to_kernel_layout(comp_v), m, denom,
            to_kernel_layout(do), start_blocks=start_blocks, **ctx.kw)
        dq, dk, dv, dck, dcv = (from_kernel_layout(g) for g in grads)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                dck.to(comp_k.dtype), dcv.to(comp_v.dtype), None, None, None,
                None)


def fused_chunk_prefill_attention(
    q: torch.Tensor,        # (B, P, H, Dh) — one query chunk, model layout
    k: torch.Tensor,        # (B, P, Hkv, Dh) — the chunk's own keys
    v: torch.Tensor,
    comp_k: torch.Tensor,   # (B, M, Hkv, Dh) — full compressed slot buffer
    comp_v: torch.Tensor,   #   with the chunk's own blocks already folded in
    start_blocks,           # (B,) int — per-row absolute start block
    *,
    block_size: int,
    block_slots: int,
    scale: float,
    backward_impl: str = "fused",
) -> torch.Tensor:
    """Blockwise-causal attention for a query chunk starting at a per-row
    block offset against the slot-resident cache: the chunked-admission
    prefill path. Row b's chunk block j attends [its own block, causally |
    compressed slots of absolute blocks < start_blocks[b] + j]; the offsets
    are a device tensor, so one kernel build serves every offset.

    Trainable: when grad is enabled and an input requires it, the attention
    goes through the route ``backward_impl`` maps to: "fused" is
    :class:`ChunkPrefillAttnFn` (kernels 4r and 2 with start blocks),
    "reference" autograd through the plain prefix form. Gradients reach
    q, k, v and comp_k, comp_v (the full-buffer dk̄/dv̄); otherwise it is
    one launch of the prefix kernel."""
    if q.shape[1] % block_size != 0:
        raise ValueError(
            f"P={q.shape[1]} must be a multiple of block_size={block_size}")
    M = comp_k.shape[1]
    check_pinned_slots(
        "fused_chunk_prefill_attention", M,
        f"the full M = (max_seq/c)·r = {M}-slot compressed cache buffer")
    kw = dict(block_size=block_size, block_slots=block_slots, scale=scale)
    if _needs_grad(q, k, v, comp_k, comp_v):
        if backward_route(backward_impl) == "plain":
            return blockwise_causal_prefix_attention(
                q, k, v, comp_k, comp_v, _start_blocks(start_blocks, q),
                **kw)
        return ChunkPrefillAttnFn.apply(q, k, v, comp_k, comp_v,
                                        _start_blocks(start_blocks, q),
                                        block_size, block_slots, scale)
    out = bca.blockwise_causal_prefix_attn(
        to_kernel_layout(q), to_kernel_layout(k), to_kernel_layout(v),
        to_kernel_layout(comp_k), to_kernel_layout(comp_v),
        _start_blocks(start_blocks, q), **kw)
    return from_kernel_layout(out)


def fused_chunk_prefill_attention_q(
    q: torch.Tensor,        # (B, P, H, Dh) — one query chunk, model layout
    k: torch.Tensor,        # (B, P, Hkv, Dh) — the chunk's own keys (exact)
    v: torch.Tensor,
    comp_k: torch.Tensor,   # (B, M, Hkv, Dh) int8/fp8 page-gathered slots
    comp_v: torch.Tensor,
    comp_k_s: torch.Tensor,  # (B, M, Hkv) fp32 per-slot per-head scales
    comp_v_s: torch.Tensor,
    start_blocks,           # (B,) int — per-row absolute start block
    *,
    block_size: int,
    block_slots: int,
    scale: float,
) -> torch.Tensor:
    """Quantized-cache sibling of :func:`fused_chunk_prefill_attention`: the
    slot buffer is the page gather's int8/fp8 codes plus per-slot scales,
    dequantised inside the kernel; the chunk's own k/v are activations and
    stay in the model dtype. Forward only."""
    if q.shape[1] % block_size != 0:
        raise ValueError(
            f"P={q.shape[1]} must be a multiple of block_size={block_size}")
    M = comp_k.shape[1]
    check_pinned_slots("fused_chunk_prefill_attention_q", M,
                       f"the full M = (max_pages·r) = {M}-slot page gather")
    _forward_only("fused_chunk_prefill_attention_q", q, k, v)
    out = bca.blockwise_causal_prefix_attn_q(
        to_kernel_layout(q), to_kernel_layout(k), to_kernel_layout(v),
        to_kernel_layout(comp_k), to_kernel_layout(comp_v),
        _scales_to_kernel_layout(comp_k_s),
        _scales_to_kernel_layout(comp_v_s), _start_blocks(start_blocks, q),
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
    M = comp_k.shape[1]
    check_pinned_slots(
        "fused_decode_attention", M,
        f"the full M = (max_seq/c)·r = {M}-slot compressed cache buffer",
        grid_step=False)
    qk = q_t.reshape(B, Hkv, H // Hkv, Dh)
    out = la.decode_attn(
        qk, to_kernel_layout(raw_k), to_kernel_layout(raw_v),
        to_kernel_layout(comp_k), to_kernel_layout(comp_v),
        bias_loc, bias_glob, scale=scale)
    return out.reshape(B, 1, H, Dh)


def fused_decode_attention_q(
    q_t: torch.Tensor,        # (B, 1, H, Dh) — one decode token per row
    raw_k: torch.Tensor,      # (B, c, Hkv, Dh) int8/fp8 quantized ring
    raw_v: torch.Tensor,
    raw_k_s: torch.Tensor,    # (B, c, Hkv) fp32 per-token per-head scales
    raw_v_s: torch.Tensor,
    comp_k: torch.Tensor,     # (B, M, Hkv, Dh) int8/fp8 page-gathered slots
    comp_v: torch.Tensor,
    comp_k_s: torch.Tensor,   # (B, M, Hkv) fp32 per-slot per-head scales
    comp_v_s: torch.Tensor,
    bias_loc: torch.Tensor,   # (B, c) fp32 — 0 attendable, NEG_INF masked
    bias_glob: torch.Tensor,  # (B, M) fp32
    *,
    scale: float,
) -> torch.Tensor:
    """Quantized-cache sibling of :func:`fused_decode_attention`: the same
    GQA group fold and two cache operands, with the ring and the page
    gather as int8/fp8 codes plus per-(row, head) fp32 scales, dequantised
    inside the kernel. Forward only."""
    B, _, H, Dh = q_t.shape
    Hkv = raw_k.shape[2]
    if H % Hkv != 0:
        raise ValueError(f"H={H} query heads not a multiple of Hkv={Hkv}")
    M = comp_k.shape[1]
    check_pinned_slots("fused_decode_attention_q", M,
                       f"the full M = (max_pages·r) = {M}-slot page gather",
                       grid_step=False)
    qk = q_t.reshape(B, Hkv, H // Hkv, Dh)
    out = la.decode_attn_q(
        qk, to_kernel_layout(raw_k), to_kernel_layout(raw_v),
        to_kernel_layout(comp_k), to_kernel_layout(comp_v),
        _scales_to_kernel_layout(raw_k_s), _scales_to_kernel_layout(raw_v_s),
        _scales_to_kernel_layout(comp_k_s),
        _scales_to_kernel_layout(comp_v_s), bias_loc, bias_glob, scale=scale)
    return out.reshape(B, 1, H, Dh)


# -- the exact (bidirectional) form ------------------------------------------


def _needs_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class LinformerAttnFn(torch.autograd.Function):
    """Differentiable exact Linformer attention over (q, k̄, v̄) in model
    layout: kernel 5 forward, the JAX package's analytic backward
    (``_lin_bwd``) in plain torch, fp32. Per head, with P = softmax(S),
    S = q·k̄ᵀ·scale, o = P·v̄: dv̄ = Pᵀ·do; dP = do·v̄ᵀ;
    dS = P ∘ (dP − rowsum(dP∘P)); dq = dS·k̄·scale; dk̄ = dSᵀ·q·scale. P is
    recomputed (one small (S × K) product per head) instead of saved. The
    GQA group's gradients sum into its kv head, the fold of the JAX
    package's head repeat."""

    @staticmethod
    def forward(ctx, q, kbar, vbar, scale):
        out = la.linformer_attn(to_kernel_layout(q), to_kernel_layout(kbar),
                                to_kernel_layout(vbar), scale=scale)
        ctx.save_for_backward(q, kbar, vbar)
        ctx.scale = scale
        return from_kernel_layout(out)

    @staticmethod
    def backward(ctx, do):
        q, kbar, vbar = ctx.saved_tensors
        scale = ctx.scale
        f32 = torch.float32
        B, S, H, Dh = q.shape
        Hkv = kbar.shape[2]
        qg = q.to(f32).reshape(B, S, Hkv, H // Hkv, Dh)
        kb, vb = kbar.to(f32), vbar.to(f32)
        do32 = do.to(f32).reshape(qg.shape)
        s = torch.einsum("bshgd,bkhd->bhgsk", qg, kb) * scale
        p = torch.softmax(s, dim=-1)
        dv = torch.einsum("bhgsk,bshgd->bkhd", p, do32)
        dp = torch.einsum("bshgd,bkhd->bhgsk", do32, vb)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dq = torch.einsum("bhgsk,bkhd->bshgd", ds, kb) * scale
        dk = torch.einsum("bhgsk,bshgd->bkhd", ds, qg) * scale
        return (dq.reshape(B, S, H, Dh).to(q.dtype), dk.to(kbar.dtype),
                dv.to(vbar.dtype), None)


def fused_linformer_attention(
    q: torch.Tensor,        # (B, S, H, Dh) model layout
    kbar: torch.Tensor,     # (B, K, Hkv, Dh)
    vbar: torch.Tensor,
    *,
    scale: float,
) -> torch.Tensor:
    """Exact (bidirectional) Linformer attention through kernel 5:
    softmax(q·k̄ᵀ·scale)·v̄ over the K compressed slots, fp32 scores, output
    in q's dtype. GQA query heads read their kv head in the kernel.
    Fail-fast as the JAX package: K ≤ MAX_EXACT_K and a sequence the JAX
    kernel's default query tile can divide. Trainable: when grad is enabled
    and an input requires it, through :class:`LinformerAttnFn`."""
    check_exact_k(kbar.shape[1])
    divisor_block(q.shape[1], DEFAULT_BLOCK_Q)
    if _needs_grad(q, kbar, vbar):
        return LinformerAttnFn.apply(q, kbar, vbar, scale)
    out = la.linformer_attn(to_kernel_layout(q), to_kernel_layout(kbar),
                            to_kernel_layout(vbar), scale=scale)
    return from_kernel_layout(out)


class SeqProjectionFn(torch.autograd.Function):
    """Differentiable sequence projection out = Eᵀ·x in model layout:
    kernel 6 forward; the op is linear, so the backward is the JAX
    package's ``_sp_bwd`` in plain torch, fp32: dx = E·dout,
    dE = Σ_{b,h} x·doutᵀ, each cast to its input's dtype (a shared E sums
    one such cotangent per use, in E's dtype, as JAX does)."""

    @staticmethod
    def forward(ctx, x, E):
        out = sp.seq_projection(to_kernel_layout(x), E)
        ctx.save_for_backward(x, E)
        return from_kernel_layout(out)

    @staticmethod
    def backward(ctx, do):
        x, E = ctx.saved_tensors
        f32 = torch.float32
        do32 = do.to(f32)
        dx = dE = None
        if ctx.needs_input_grad[0]:
            dx = torch.einsum("bkhd,sk->bshd", do32, E.to(f32)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dE = torch.einsum("bshd,bkhd->sk", x.to(f32), do32).to(E.dtype)
        return dx, dE


def fused_seq_projection(
    x: torch.Tensor,        # (B, S, H, Dh)
    E: torch.Tensor,        # (S, K)
) -> torch.Tensor:
    """Sequence-axis projection out = Eᵀ·x through kernel 6:
    (B, S, H, Dh) × (S, K) → (B, K, H, Dh), the paper's shared linear
    compression of K/V. Handles only the shared 2-D E with exactly S rows
    (the plan slices E[:S]; per-head, conv and pool projections go through
    core/linformer.project_kv). Fail-fast as the JAX package: a sequence
    its default sequence tile can divide. Trainable through
    :class:`SeqProjectionFn`."""
    divisor_block(x.shape[1], DEFAULT_BLOCK_S)
    if _needs_grad(x, E):
        return SeqProjectionFn.apply(x, E)
    return from_kernel_layout(sp.seq_projection(to_kernel_layout(x), E))

"""Blockwise-causal Linformer attention, forward and backward: the CUDA
kernels' wrappers and their plain PyTorch twins.

Counterpart of ``repro/kernels/blockwise_causal_attn.py``: the forward
``blockwise_causal_attn`` in its plain and residual-emitting forms
(``return_residuals=True``, the TPU's ``_kernel_res``), its prefix form
``blockwise_causal_prefix_attn`` (a query chunk at per-row start blocks
against a full slot buffer, both forms) and that form over a quantized
slot buffer, ``blockwise_causal_prefix_attn_q``, and the backward
``blockwise_causal_attn_bwd`` (the TPU's ``_bwd_kernel``). Kernel layout:
q (B, H, S, Dh); k, v (B, Hkv, S, Dh); k̄, v̄ (B, Hkv, M, Dh) with
M = (S/c)·r (any M for the prefix forms). Query block n of (b, h) takes one
joint softmax over its own block (causal, c × c) and the compressed slots
m < (start_blocks[b] + n)·r; grouped query head h reads kv head h // G.

Each wrapper runs the plain twin for a CPU tensor and the CUDA kernel
(``csrc/blockwise_causal_attn.cu``, ``csrc/blockwise_causal_attn_bwd.cu``)
for a CUDA tensor, counting launches in ``<wrapper>.launches`` (and
``<wrapper>.residual_launches`` for a residual form;
``blockwise_causal_attn_bwd.offset_launches`` counts the backward's
launches with start blocks, the offset form, among its ``launches``).
FakeTensor operands take the fake path (``common.is_fake``): the launch's
allocations and checks without the kernel, no counter moved, and the
kernel's cost (``*_cost``: flops and bytes from the shapes, the visible
keys only, each byte read or written once; fake start blocks have no
values, so every slot counts as seen) reported to ``common.add_cost``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.cache import dequantize_blockwise
from repro_torch.core.causal import NEG_INF
from repro_torch.kernels import build
from repro_torch.kernels import common


def joint_scores(q, k, kbar, cut, *, block_size: int, block_slots: int,
                 scale: float):
    """Masked fp32 scores of every query block (the TPU's
    ``_joint_scores``): local (B, Hkv, G, nb, c, c) causal scores and global
    (B, Hkv, G, nb, c, M) scores over the slots of blocks < cut, where
    `cut` (B, nb) or (1, nb) is each query block's visibility cut."""
    B, H, S, Dh = q.shape
    Hkv = k.shape[1]
    c, nb = block_size, S // block_size
    M = kbar.shape[2]
    f32 = torch.float32
    qg = q.reshape(B, Hkv, H // Hkv, nb, c, Dh).to(f32)
    kl = k.reshape(B, Hkv, nb, c, Dh).to(f32)
    s_loc = torch.einsum("bhgncd,bhnkd->bhgnck", qg, kl) * scale
    causal = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    s_loc = s_loc.masked_fill(~causal, NEG_INF)
    s_glob = torch.einsum("bhgncd,bhmd->bhgncm", qg, kbar.to(f32)) * scale
    slot_blk = torch.arange(M, device=q.device) // block_slots
    vis = slot_blk[None, None, :] < cut[:, :, None]           # (B|1, nb, M)
    s_glob = s_glob.masked_fill(~vis[:, None, None, :, None, :], NEG_INF)
    return s_loc, s_glob


def _visibility_cut(nb: int, start_blocks, device) -> torch.Tensor:
    """(B|1, nb) visibility cut of each query block: n + start_blocks[b]."""
    cut = torch.arange(nb, device=device)[None]
    if start_blocks is None:
        return cut
    return cut + start_blocks.to(device=device, dtype=torch.long)[:, None]


def blockwise_causal_attn_plain(q, k, v, kbar, vbar, *, block_size: int,
                                block_slots: int, scale: float,
                                return_residuals: bool = False,
                                start_blocks: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the forward kernel, with the TPU kernel's
    cast points (``_attend_block``): fp32 scores and products,
    probabilities normalised in fp32 and cast to the value dtype before the
    value product, output cast to q's dtype. With ``return_residuals``
    also the joint softmax's per-row max and denominator, (B, H, S) fp32.
    `start_blocks` (B,) shifts each row's visibility cut (the prefix form,
    ``_prefix_kernel``); None means zeros."""
    B, H, S, Dh = q.shape
    Hkv = k.shape[1]
    c, nb = block_size, S // block_size
    f32 = torch.float32
    cut = _visibility_cut(nb, start_blocks, q.device)
    s_loc, s_glob = joint_scores(q, k, kbar, cut, block_size=block_size,
                                 block_slots=block_slots, scale=scale)
    m = s_loc.amax(-1, keepdim=True)
    if s_glob.shape[-1]:                      # M = 0: no slot to take a max of
        m = torch.maximum(m, s_glob.amax(-1, keepdim=True))
    p_loc = torch.exp(s_loc - m)
    p_glob = torch.exp(s_glob - m)
    denom = p_loc.sum(-1, keepdim=True) + p_glob.sum(-1, keepdim=True)
    vl = v.reshape(B, Hkv, nb, c, Dh)
    out = torch.einsum("bhgnck,bhnkd->bhgncd",
                       (p_loc / denom).to(v.dtype).to(f32), vl.to(f32))
    out = out + torch.einsum("bhgncm,bhmd->bhgncd",
                             (p_glob / denom).to(vbar.dtype).to(f32),
                             vbar.to(f32))
    out = out.reshape(B, H, S, Dh).to(q.dtype)
    if return_residuals:
        return out, m.reshape(B, H, S), denom.reshape(B, H, S)
    return out


def blockwise_causal_attn_bwd_plain(q, k, v, kbar, vbar, m, denom, do, *,
                                    block_size: int, block_slots: int,
                                    scale: float,
                                    start_blocks: Optional[torch.Tensor] = None
                                    ):
    """Plain PyTorch version of the backward kernel, step by step as the
    TPU's ``_bwd_kernel``: recompute p = exp(s − m)/denom over the joint row
    (visibility cut at n + start_blocks[b]), dv = Pᵀ·dO, dP = dO·Vᵀ,
    dS = P∘(dP − rowsum(dP∘P)), dq = dS·K·scale, dk = dSᵀ·Q·scale, all in
    fp32, summed over the G query heads of a group. Returns (dq in q's
    dtype, dk_loc, dv_loc (B, Hkv, S, Dh) fp32, dk̄, dv̄ (B, Hkv, M, Dh)
    fp32); slots no query row sees get exact zeros."""
    B, H, S, Dh = q.shape
    Hkv = k.shape[1]
    G, c, nb = H // Hkv, block_size, S // block_size
    M = kbar.shape[2]
    f32 = torch.float32
    cut = _visibility_cut(nb, start_blocks, q.device)
    s_loc, s_glob = joint_scores(q, k, kbar, cut, block_size=block_size,
                                 block_slots=block_slots, scale=scale)
    rows = (B, Hkv, G, nb, c, 1)
    mm, dd = m.reshape(rows), denom.reshape(rows)
    p_loc = torch.exp(s_loc - mm) / dd                        # joint probs
    p_glob = torch.exp(s_glob - mm) / dd
    q32 = q.reshape(B, Hkv, G, nb, c, Dh).to(f32)
    kl32 = k.reshape(B, Hkv, nb, c, Dh).to(f32)
    vl32 = v.reshape(B, Hkv, nb, c, Dh).to(f32)
    kbar32, vbar32 = kbar.to(f32), vbar.to(f32)
    do32 = do.reshape(B, Hkv, G, nb, c, Dh).to(f32)

    dv_loc = torch.einsum("bhgnck,bhgncd->bhnkd", p_loc, do32)
    dvbar = torch.einsum("bhgncm,bhgncd->bhmd", p_glob, do32)
    dp_loc = torch.einsum("bhgncd,bhnkd->bhgnck", do32, vl32)
    dp_glob = torch.einsum("bhgncd,bhmd->bhgncm", do32, vbar32)
    delta = ((dp_loc * p_loc).sum(-1, keepdim=True)
             + (dp_glob * p_glob).sum(-1, keepdim=True))
    ds_loc = p_loc * (dp_loc - delta)
    ds_glob = p_glob * (dp_glob - delta)
    dq = torch.einsum("bhgnck,bhnkd->bhgncd", ds_loc, kl32)
    dq = dq + torch.einsum("bhgncm,bhmd->bhgncd", ds_glob, kbar32)
    dk_loc = torch.einsum("bhgnck,bhgncd->bhnkd", ds_loc, q32) * scale
    dkbar = torch.einsum("bhgncm,bhgncd->bhmd", ds_glob, q32) * scale
    return ((dq * scale).reshape(B, H, S, Dh).to(q.dtype),
            dk_loc.reshape(B, Hkv, S, Dh), dv_loc.reshape(B, Hkv, S, Dh),
            dkbar, dvbar)


def _check_qkv(q, k, v, kbar, vbar) -> None:
    B, H, S, Dh = q.shape
    Hkv = k.shape[1]
    M = kbar.shape[2]
    if H % Hkv != 0 or k.shape != (B, Hkv, S, Dh) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / "
                         f"v {tuple(v.shape)}: expected k, v (B, Hkv, S, Dh)"
                         " with Hkv dividing H")
    if kbar.shape != (B, Hkv, M, Dh) or vbar.shape != kbar.shape:
        raise ValueError(f"kbar {tuple(kbar.shape)} / vbar "
                         f"{tuple(vbar.shape)}: expected (B, Hkv, M, Dh)")


def _model_layout_empty(B, H, S, Dh, dtype, device) -> torch.Tensor:
    """An output in model-layout memory (B, S, H, Dh), as its kernel-layout
    view (B, H, S, Dh)."""
    return torch.empty((B, S, H, Dh), dtype=dtype, device=device).movedim(1, 2)


def _slot_scales(kbar_scale, vbar_scale, kbar):
    """Pointers and strides of quantized slots' scales (null for dense
    slots); k̄'s and v̄'s scales share one stride set."""
    if kbar_scale is None:
        return None, None, (None, (0, 1, 2))
    common.check_scales(kbar, kbar_scale, vbar_scale)
    kbar_scale, vbar_scale = common.same_strides(kbar_scale, vbar_scale)
    return kbar_scale, vbar_scale, (kbar_scale, (0, 1, 2))


def launch(kl: Optional[build.KernelLibrary], q, k, v, kbar, vbar, *,
           block_size: int, block_slots: int, scale: float, stream,
           return_residuals: bool = False,
           start_blocks: Optional[torch.Tensor] = None,
           kbar_scale: Optional[torch.Tensor] = None,
           vbar_scale: Optional[torch.Tensor] = None):
    """Check the operands, allocate the outputs and launch the forward
    kernel on `stream` (no synchronisation). With `start_blocks` (B,)
    int32 it is the prefix form (any M); with `kbar_scale`/`vbar_scale`
    (B, Hkv, M) fp32 the slots are int8/fp8 codes. The output lies in model
    layout memory (B, S, H, Dh), returned as its kernel-layout view; with
    `return_residuals` also m and denom, contiguous (B, H, S) fp32.
    `kl` None (the fake path) allocates and checks, and launches
    nothing."""
    _check_qkv(q, k, v, kbar, vbar)
    B, H, S, Dh = q.shape
    Hkv, M = k.shape[1], kbar.shape[2]
    dtype = common.kernel_dtype_code(q, k, v)
    slot_dtype = (common.kernel_dtype_code(q, kbar, vbar)
                  if kbar_scale is None
                  else common.storage_dtype_code(kbar, vbar))
    if start_blocks is None:
        common.check_blockwise_shapes(seq=S, block_size=block_size,
                                      block_slots=block_slots, slots=M,
                                      head_dim=Dh, group=H // Hkv,
                                      dtype=q.dtype)
    else:
        common.check_prefix_shapes(seq=S, block_size=block_size,
                                   block_slots=block_slots, slots=M,
                                   head_dim=Dh, group=H // Hkv,
                                   dtype=q.dtype, slot_dtype=kbar.dtype)
        common.check_start_blocks(start_blocks, B, q.device)
    k, v = common.same_strides(k, v)
    kbar, vbar = common.same_strides(kbar, vbar)
    kbar_scale, vbar_scale, scale_strides = _slot_scales(
        kbar_scale, vbar_scale, kbar)
    out = _model_layout_empty(B, H, S, Dh, q.dtype, q.device)
    common.check_operands(q, k, v, kbar, vbar, out)
    if kbar_scale is not None and kbar_scale.device != q.device:
        raise ValueError(f"scales on {kbar_scale.device}, q on {q.device}")
    m = denom = None
    if return_residuals:
        m = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        denom = torch.empty_like(m)
    if kl is None:                                # the fake path
        return (out, m, denom) if return_residuals else out
    dims = (0, 1, 2)
    strides = build.strides_arg((q, dims), (k, dims), (kbar, dims),
                                (out, dims), scale_strides)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = kl.lib.bca_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kbar.data_ptr(),
        vbar.data_ptr(), out.data_ptr(), ptr(m), ptr(denom),
        ptr(start_blocks), ptr(kbar_scale), ptr(vbar_scale), strides, B, H,
        Hkv, S, M, Dh, block_size, block_slots, float(scale), dtype,
        slot_dtype, stream)
    kl.check(rc, "blockwise_causal_attn")
    return (out, m, denom) if return_residuals else out


def blockwise_causal_attn_cost(B: int, H: int, Hkv: int, S: int, Dh: int, *,
                               block_size: int, block_slots: int,
                               dtype_bytes: int = 2,
                               return_residuals: bool = False
                               ) -> Tuple[int, int]:
    """(flops, bytes) of kernel 1 (1r with `return_residuals`): reads q,
    k, v and the M = (S/c)·r slots, writes the output (and m, denom in
    fp32); 4·Dh flops a visible (row, key) pair."""
    M = (S // block_size) * block_slots
    nbytes = dtype_bytes * (2 * B * H * S * Dh + 2 * B * Hkv * S * Dh
                            + 2 * B * Hkv * M * Dh)
    if return_residuals:
        nbytes += 2 * 4 * B * H * S
    pairs = common.visible_pairs(S, block_size, block_slots) * B * H
    return 4 * Dh * pairs, nbytes


def blockwise_causal_prefix_attn_cost(B: int, H: int, Hkv: int, P: int,
                                      Dh: int, M: int, *, block_size: int,
                                      block_slots: int,
                                      start_blocks: Optional[Sequence[int]],
                                      dtype_bytes: int = 2,
                                      slot_bytes: Optional[float] = None,
                                      return_residuals: bool = False
                                      ) -> Tuple[int, int]:
    """(flops, bytes) of kernels 4, 4r and 8: reads q and the chunk's k, v,
    and of the slot buffer only the slots its rows see
    (``common.prefix_visible``; every slot when `start_blocks` is None),
    writes the output (4r: and m, denom). `slot_bytes` is a slot row's
    bytes a head (kernel 8: Dh codes and a 4-byte scale; default Dh in
    the model dtype)."""
    pairs, slots = common.prefix_visible(P, block_size, block_slots, M,
                                         start_blocks, B)
    row = dtype_bytes * Dh if slot_bytes is None else slot_bytes
    nbytes = (dtype_bytes * (2 * B * H * P * Dh + 2 * B * Hkv * P * Dh)
              + 2 * slots * Hkv * row)
    if return_residuals:
        nbytes += 2 * 4 * B * H * P
    return 4 * Dh * pairs * H, int(nbytes)


def blockwise_causal_attn_bwd_cost(B: int, H: int, Hkv: int, S: int,
                                   Dh: int, M: int, *, block_size: int,
                                   block_slots: int,
                                   start_blocks: Optional[Sequence[int]]
                                   = None, offset: bool = False,
                                   dtype_bytes: int = 2) -> Tuple[int, int]:
    """(flops, bytes) of kernel 2: reads q, k, v, the slots and dO (model
    dtype) and (m, denom) (fp32), writes dq (model dtype) and dk_loc,
    dv_loc, dk̄, dv̄ (fp32); 10·Dh flops a visible pair. Its offset form
    (`offset`, per-row `start_blocks`, None when unknown) reads only the
    slots its rows see."""
    rows = B * H * S
    grads = 4 * 2 * (B * Hkv * S * Dh + B * Hkv * M * Dh)
    if not offset:
        nbytes = (dtype_bytes * (rows * Dh + 2 * B * Hkv * S * Dh
                                 + 2 * B * Hkv * M * Dh)
                  + dtype_bytes * rows * Dh + 2 * 4 * rows
                  + dtype_bytes * rows * Dh + grads)
        pairs = common.visible_pairs(S, block_size, block_slots) * B * H
        return 10 * Dh * pairs, nbytes
    pairs, slots = common.prefix_visible(S, block_size, block_slots, M,
                                         start_blocks, B)
    nbytes = (dtype_bytes * (2 * rows * Dh + 2 * B * Hkv * S * Dh
                             + 2 * slots * Hkv * Dh)
              + 2 * 4 * rows + dtype_bytes * rows * Dh + grads)
    return 10 * Dh * pairs * H, nbytes


ROUTES = {0: "simt", 1: "tensor cores"}


def last_forward_route() -> str:
    """The kernel the last CUDA launch of the forward wrappers ran: "simt"
    (bca_fwd_kernel: fp32) or "tensor cores" (bca_prefix_mma_kernel: bf16,
    every form). A probe for the tests of the routes; it builds the library
    if need be."""
    code = build.library().lib.bca_forward_route()
    if code not in ROUTES:
        raise RuntimeError("no blockwise-causal forward launched yet")
    return ROUTES[code]


def last_backward_route() -> str:
    """The kernels the last CUDA launch of the backward wrapper ran: "simt"
    (bca_bwd_dq_kernel and bca_bwd_dkdv_kernel: fp32) or "tensor cores"
    (bca_bwd_dq_mma_kernel, bca_bwd_dkdv_mma_kernel and the reduction of
    the slot splits: bf16). A probe for the tests of the routes; it builds
    the library if need be."""
    code = build.library().lib.bca_backward_route()
    if code not in ROUTES:
        raise RuntimeError("no blockwise-causal backward launched yet")
    return ROUTES[code]


def blockwise_causal_attn(q, k, v, kbar, vbar, *, block_size: int,
                          block_slots: int, scale: float,
                          return_residuals: bool = False):
    """Blockwise-causal attention forward in kernel layout; with
    ``return_residuals`` also the per-row (m, denom), (B, H, S) fp32, that
    :func:`blockwise_causal_attn_bwd` recomputes the probabilities from. A
    CPU tensor runs the plain twin; a CUDA tensor launches the CUDA kernel
    on the current stream (or raises)."""
    kw = dict(block_size=block_size, block_slots=block_slots, scale=scale,
              return_residuals=return_residuals)
    if not q.is_cuda and not common.is_fake(q):
        return blockwise_causal_attn_plain(q, k, v, kbar, vbar, **kw)
    kl, stream = common.kernel_route(q)
    out = launch(kl, q, k, v, kbar, vbar, stream=stream, **kw)
    if kl is not None and return_residuals:
        blockwise_causal_attn.residual_launches += 1
    elif kl is not None:
        blockwise_causal_attn.launches += 1
    else:
        B, H, S, Dh = q.shape
        common.add_cost(
            "blockwise_causal_attn(return_residuals)" if return_residuals
            else "blockwise_causal_attn",
            blockwise_causal_attn_cost(
                B, H, k.shape[1], S, Dh, block_size=block_size,
                block_slots=block_slots, dtype_bytes=q.element_size(),
                return_residuals=return_residuals))
    return out


blockwise_causal_attn.launches = 0
blockwise_causal_attn.residual_launches = 0


def blockwise_causal_prefix_attn(q, k, v, comp_k, comp_v, start_blocks, *,
                                 block_size: int, block_slots: int,
                                 scale: float,
                                 return_residuals: bool = False):
    """Prefix form in kernel layout: query chunk q (B, H, P, Dh) whose row b
    starts at absolute block start_blocks[b] (B,) int32, against the
    chunk's own k/v (B, Hkv, P, Dh) and a full slot buffer comp_k/comp_v
    (B, Hkv, M, Dh) holding the chunk's own blocks already folded in; chunk
    block n sees the slots of absolute blocks < start_blocks[b] + n. With
    ``return_residuals`` also (m, denom), (B, H, P) fp32. A CPU tensor runs
    the plain twin; a CUDA tensor launches the CUDA kernel (or raises)."""
    kw = dict(block_size=block_size, block_slots=block_slots, scale=scale,
              return_residuals=return_residuals)
    if not q.is_cuda and not common.is_fake(q):
        return blockwise_causal_attn_plain(q, k, v, comp_k, comp_v,
                                           start_blocks=start_blocks, **kw)
    kl, stream = common.kernel_route(q)
    out = launch(kl, q, k, v, comp_k, comp_v, start_blocks=start_blocks,
                 stream=stream, **kw)
    if kl is not None and return_residuals:
        blockwise_causal_prefix_attn.residual_launches += 1
    elif kl is not None:
        blockwise_causal_prefix_attn.launches += 1
    else:
        B, H, P, Dh = q.shape
        common.add_cost(
            "blockwise_causal_prefix_attn(return_residuals)"
            if return_residuals else "blockwise_causal_prefix_attn",
            blockwise_causal_prefix_attn_cost(
                B, H, k.shape[1], P, Dh, comp_k.shape[2],
                block_size=block_size, block_slots=block_slots,
                start_blocks=None, dtype_bytes=q.element_size(),
                return_residuals=return_residuals))
    return out


blockwise_causal_prefix_attn.launches = 0
blockwise_causal_prefix_attn.residual_launches = 0


def blockwise_causal_prefix_attn_q_plain(q, k, v, comp_k, comp_v, comp_k_s,
                                         comp_v_s, start_blocks, *,
                                         block_size: int, block_slots: int,
                                         scale: float) -> torch.Tensor:
    """Plain PyTorch version of the quantized prefix kernel
    (``_prefix_kernel_q``): the slots dequantised to fp32, q and the chunk's
    own k/v cast to fp32, then the prefix form's plain twin in fp32; the
    output cast to q's dtype."""
    f32 = torch.float32
    out = blockwise_causal_attn_plain(
        q.to(f32), k.to(f32), v.to(f32),
        dequantize_blockwise(comp_k, comp_k_s),
        dequantize_blockwise(comp_v, comp_v_s), block_size=block_size,
        block_slots=block_slots, scale=scale, start_blocks=start_blocks)
    return out.to(q.dtype)


def blockwise_causal_prefix_attn_q(q, k, v, comp_k, comp_v, comp_k_s,
                                   comp_v_s, start_blocks, *,
                                   block_size: int, block_slots: int,
                                   scale: float) -> torch.Tensor:
    """Prefix form over a quantized slot buffer, in kernel layout: comp_k /
    comp_v (B, Hkv, M, Dh) int8 or fp8 codes with per-slot fp32 scales
    comp_k_s / comp_v_s (B, Hkv, M), dequantised in the kernel; q and the
    chunk's own k/v in the model dtype. Forward only. A CPU tensor runs the
    plain twin; a CUDA tensor launches the CUDA kernel (or raises)."""
    kw = dict(block_size=block_size, block_slots=block_slots, scale=scale)
    if not q.is_cuda and not common.is_fake(q):
        return blockwise_causal_prefix_attn_q_plain(
            q, k, v, comp_k, comp_v, comp_k_s, comp_v_s, start_blocks, **kw)
    kl, stream = common.kernel_route(q)
    out = launch(kl, q, k, v, comp_k, comp_v, start_blocks=start_blocks,
                 kbar_scale=comp_k_s, vbar_scale=comp_v_s, stream=stream,
                 **kw)
    if kl is not None:
        blockwise_causal_prefix_attn_q.launches += 1
    else:
        B, H, P, Dh = q.shape
        common.add_cost("blockwise_causal_prefix_attn_q",
                        blockwise_causal_prefix_attn_cost(
                            B, H, k.shape[1], P, Dh, comp_k.shape[2],
                            block_size=block_size, block_slots=block_slots,
                            start_blocks=None, dtype_bytes=q.element_size(),
                            slot_bytes=Dh * comp_k.element_size() + 4))
    return out


blockwise_causal_prefix_attn_q.launches = 0


def launch_bwd(kl: Optional[build.KernelLibrary], q, k, v, kbar, vbar, m,
               denom, do, *, block_size: int, block_slots: int, scale: float,
               stream, start_blocks: Optional[torch.Tensor] = None):
    """Check the operands, allocate the gradients and the scratch (delta;
    in bf16 the slot splits' partials) and launch the backward kernels (dq,
    then dk/dv, then in bf16 the reduction of the partials) on `stream`.
    Gradients lie in model-layout memory, returned as kernel-layout
    views. `kl` None (the fake path) allocates and checks, and launches
    nothing."""
    _check_qkv(q, k, v, kbar, vbar)
    B, H, S, Dh = q.shape
    Hkv, M = k.shape[1], kbar.shape[2]
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} != q {tuple(q.shape)}")
    for name, t in (("m", m), ("denom", denom)):
        if t.shape != (B, H, S) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous (B, H, S) fp32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    common.check_blockwise_bwd_shapes(
        seq=S, block_size=block_size, block_slots=block_slots, slots=M,
        head_dim=Dh, offset=start_blocks is not None, group=H // Hkv,
        dtype=q.dtype)
    if start_blocks is not None:
        common.check_start_blocks(start_blocks, B, q.device)
    dtype = common.kernel_dtype_code(q, k, v, kbar, vbar, do)
    k, v = common.same_strides(k, v)
    kbar, vbar = common.same_strides(kbar, vbar)
    f32 = torch.float32
    dq = _model_layout_empty(B, H, S, Dh, q.dtype, q.device)
    dk = _model_layout_empty(B, Hkv, S, Dh, f32, q.device)
    dv = _model_layout_empty(B, Hkv, S, Dh, f32, q.device)
    dkbar = _model_layout_empty(B, Hkv, M, Dh, f32, q.device)
    dvbar = _model_layout_empty(B, Hkv, M, Dh, f32, q.device)
    delta = torch.empty((B, H, S), dtype=f32, device=q.device)
    part = None
    if q.dtype == torch.bfloat16:
        part = torch.empty(common.bca_bwd_partials_shape(B, Hkv, S, M, Dh),
                           dtype=f32, device=q.device)
    common.check_operands(q, k, v, kbar, vbar, do, m, denom, dq, dk, dv,
                          dkbar, dvbar, delta)
    if kl is None:                                # the fake path
        return dq, dk, dv, dkbar, dvbar
    dims = (0, 1, 2)
    strides = build.strides_arg((q, dims), (k, dims), (kbar, dims),
                                (do, dims), (dq, dims), (dk, dims),
                                (dkbar, dims))
    rc = kl.lib.bca_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kbar.data_ptr(),
        vbar.data_ptr(), do.data_ptr(), m.data_ptr(), denom.data_ptr(),
        None if start_blocks is None else start_blocks.data_ptr(),
        dq.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dkbar.data_ptr(), dvbar.data_ptr(),
        None if part is None else part.data_ptr(), strides, B, H, Hkv, S, M,
        Dh, block_size, block_slots, float(scale), dtype, stream)
    kl.check(rc, "blockwise_causal_attn_bwd")
    return dq, dk, dv, dkbar, dvbar


def blockwise_causal_attn_bwd(q, k, v, kbar, vbar, m, denom, do, *,
                              block_size: int, block_slots: int,
                              scale: float,
                              start_blocks: Optional[torch.Tensor] = None):
    """Backward of :func:`blockwise_causal_attn` from its residuals, in
    kernel layout: (dq in q's dtype, dk_loc, dv_loc, dk̄, dv̄ in fp32).
    `start_blocks` (B,) int32 shifts each row's visibility cut (the offset
    form; k̄/v̄ then hold M ≥ (start + S/c)·r slots); None means zeros. A CPU
    tensor runs the plain twin; a CUDA tensor launches the CUDA kernels on
    the current stream (or raises)."""
    kw = dict(block_size=block_size, block_slots=block_slots, scale=scale,
              start_blocks=start_blocks)
    if not q.is_cuda and not common.is_fake(q):
        return blockwise_causal_attn_bwd_plain(q, k, v, kbar, vbar, m, denom,
                                               do, **kw)
    kl, stream = common.kernel_route(q)
    out = launch_bwd(kl, q, k, v, kbar, vbar, m, denom, do, stream=stream,
                     **kw)
    if kl is not None:
        blockwise_causal_attn_bwd.launches += 1
        if start_blocks is not None:
            blockwise_causal_attn_bwd.offset_launches += 1
    else:
        B, H, S, Dh = q.shape
        common.add_cost(
            "blockwise_causal_attn_bwd" if start_blocks is None
            else "blockwise_causal_attn_bwd(start_blocks)",
            blockwise_causal_attn_bwd_cost(
                B, H, k.shape[1], S, Dh, kbar.shape[2],
                block_size=block_size, block_slots=block_slots,
                start_blocks=None, offset=start_blocks is not None,
                dtype_bytes=q.element_size()))
    return out


blockwise_causal_attn_bwd.launches = 0
blockwise_causal_attn_bwd.offset_launches = 0

"""Blockwise-causal Linformer attention forward: the CUDA kernel's wrapper
and its plain PyTorch twin.

Counterpart of ``repro/kernels/blockwise_causal_attn.py`` (plain form of
``blockwise_causal_attn``). Kernel layout: q (B, H, S, Dh); k, v
(B, Hkv, S, Dh); k̄, v̄ (B, Hkv, M, Dh) with M = (S/c)·r. Query block n of
(b, h) takes one joint softmax over its own block (causal, c × c) and the
compressed slots m < n·r; grouped query head h reads kv head h // G.

``blockwise_causal_attn`` runs the plain twin for a CPU tensor and the CUDA
kernel (``csrc/blockwise_causal_attn.cu``) for a CUDA tensor, counting its
launches in ``blockwise_causal_attn.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.core.causal import NEG_INF
from repro_torch.kernels import build
from repro_torch.kernels import common


def blockwise_causal_attn_plain(q, k, v, kbar, vbar, *, block_size: int,
                                block_slots: int, scale: float
                                ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the TPU kernel's cast
    points (``_attend_block``): fp32 scores and products, probabilities
    normalised in fp32 and cast to the value dtype before the value
    product, output cast to q's dtype."""
    B, H, S, Dh = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    c, r = block_size, block_slots
    nb = S // c
    M = kbar.shape[2]
    f32 = torch.float32
    qg = q.reshape(B, Hkv, G, nb, c, Dh).to(f32)
    kl = k.reshape(B, Hkv, nb, c, Dh).to(f32)
    vl = v.reshape(B, Hkv, nb, c, Dh)
    s_loc = torch.einsum("bhgncd,bhnkd->bhgnck", qg, kl) * scale
    causal = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    s_loc = s_loc.masked_fill(~causal, NEG_INF)
    s_glob = torch.einsum("bhgncd,bhmd->bhgncm", qg, kbar.to(f32)) * scale
    slot_blk = torch.arange(M, device=q.device) // r
    vis = slot_blk[None, :] < torch.arange(nb, device=q.device)[:, None]
    s_glob = s_glob.masked_fill(~vis[:, None, :], NEG_INF)
    m = torch.maximum(s_loc.amax(-1, keepdim=True),
                      s_glob.amax(-1, keepdim=True))
    p_loc = torch.exp(s_loc - m)
    p_glob = torch.exp(s_glob - m)
    denom = p_loc.sum(-1, keepdim=True) + p_glob.sum(-1, keepdim=True)
    out = torch.einsum("bhgnck,bhnkd->bhgncd",
                       (p_loc / denom).to(v.dtype).to(f32), vl.to(f32))
    out = out + torch.einsum("bhgncm,bhmd->bhgncd",
                             (p_glob / denom).to(vbar.dtype).to(f32),
                             vbar.to(f32))
    return out.reshape(B, H, S, Dh).to(q.dtype)


def launch(kl: build.KernelLibrary, q, k, v, kbar, vbar, *, block_size: int,
           block_slots: int, scale: float, stream) -> torch.Tensor:
    """Check the operands, allocate the output and launch the kernel on
    `stream` (no synchronisation). The output lies in model layout memory
    (B, S, H, Dh), returned as its kernel-layout view."""
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
    common.check_blockwise_shapes(seq=S, block_size=block_size,
                                  block_slots=block_slots, slots=M,
                                  head_dim=Dh)
    dtype = common.kernel_dtype_code(q, k, v, kbar, vbar)
    if k.stride() != v.stride():
        v = v.contiguous()
        k = k.contiguous()
    if kbar.stride() != vbar.stride():
        kbar, vbar = kbar.contiguous(), vbar.contiguous()
    out = torch.empty((B, S, H, Dh), dtype=q.dtype,
                      device=q.device).movedim(1, 2)
    common.check_operands(q, k, v, kbar, vbar, out)
    dims = (0, 1, 2)
    strides = build.strides_arg((q, dims), (k, dims), (kbar, dims),
                                (out, dims))
    rc = kl.lib.bca_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kbar.data_ptr(),
        vbar.data_ptr(), out.data_ptr(), strides, B, H, Hkv, S, M, Dh,
        block_size, block_slots, float(scale), dtype, stream)
    kl.check(rc, "blockwise_causal_attn")
    return out


def blockwise_causal_attn(q, k, v, kbar, vbar, *, block_size: int,
                          block_slots: int, scale: float) -> torch.Tensor:
    """Blockwise-causal attention forward in kernel layout. A CPU tensor
    runs the plain twin; a CUDA tensor launches the CUDA kernel on the
    current stream (or raises)."""
    if not q.is_cuda:
        return blockwise_causal_attn_plain(
            q, k, v, kbar, vbar, block_size=block_size,
            block_slots=block_slots, scale=scale)
    out = launch(build.library(), q, k, v, kbar, vbar,
                 block_size=block_size, block_slots=block_slots, scale=scale,
                 stream=torch.cuda.current_stream(q.device).cuda_stream)
    blockwise_causal_attn.launches += 1
    return out


blockwise_causal_attn.launches = 0

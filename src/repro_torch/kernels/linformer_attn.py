"""Attention over the compressed keys and values: the exact (bidirectional)
Linformer attention and the single-token decode over the compressed cache,
the CUDA kernels' wrappers and their plain PyTorch twins.

Counterpart of ``repro/kernels/linformer_attn.py``:

* ``linformer_attn`` (kernel 5, ``csrc/linformer_attn.cu``): the exact
  form, softmax(q·k̄ᵀ·scale)·v̄ over all K slots. Kernel layout: q
  (B, H, S, Dh); k̄, v̄ (B, Hkv, K, Dh), query head h reading kv head h // G
  (the TPU wrapper repeats k̄/v̄ to H heads before the call); output in q's
  dtype.
* ``decode_attn`` and ``decode_attn_q`` (kernels 3 and 7,
  ``csrc/decode_attn.cu``): q (B, Hkv, G, Dh) with the GQA group folded
  into the query axis; ring (B, Hkv, c, Dh); slots (B, Hkv, M, Dh); additive
  fp32 biases (B, c) and (B, M), 0 for attendable and NEG_INF for masked.
  Per (b, kv head) the G query rows take one softmax over [ring | slots].
  ``decode_attn_q`` takes the ring and the page-gathered slots as int8 or
  fp8 codes with fp32 scales (B, Hkv, c) per token and (B, Hkv, M) per slot.
  On the card the key range is split over thread blocks
  (``common.decode_splits``) and a second kernel merges the splits, with
  fp32 scratch the wrapper allocates.

Each wrapper runs the plain twin for a CPU tensor and the CUDA kernel for a
CUDA tensor, counting its launches in ``<wrapper>.launches``; FakeTensor
operands take the fake path (``common.is_fake``: the launch's allocations
and checks, no kernel and no counter moved, the cost of ``*_cost`` to
``common.add_cost``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.cache import dequantize_blockwise
from repro_torch.kernels import build
from repro_torch.kernels import common


def linformer_attn_plain(q, kbar, vbar, *, scale: float) -> torch.Tensor:
    """Plain PyTorch version of kernel 5, with the TPU kernel's cast points
    (``_softmax_attend``): fp32 scores, the normalised probabilities cast to
    v̄'s dtype before the value product (fp32 products), output cast to q's
    dtype. q (B, H, S, Dh); k̄, v̄ (B, Hkv, K, Dh)."""
    f32 = torch.float32
    B, H, S, Dh = q.shape
    Hkv = kbar.shape[1]
    qg = q.to(f32).reshape(B, Hkv, H // Hkv, S, Dh)
    s = torch.einsum("bhgsd,bhkd->bhgsk", qg, kbar.to(f32)) * scale
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bhgsk,bhkd->bhgsd", p.to(vbar.dtype).to(f32),
                       vbar.to(f32))
    return out.reshape(B, H, S, Dh).to(q.dtype)


def linformer_attn_cost(B: int, H: int, Hkv: int, S: int, K: int, Dh: int,
                        *, dtype_bytes: int = 2) -> Tuple[int, int]:
    """(flops, bytes) of kernel 5: reads q, k̄, v̄, writes the output; 4·Dh
    flops a (row, slot) pair."""
    return (4 * Dh * S * K * B * H,
            dtype_bytes * (2 * B * H * S * Dh + 2 * B * Hkv * K * Dh))


def decode_attn_cost(B: int, Hkv: int, G: int, Dh: int, c: int, M: int, *,
                     positions: Optional[Sequence[int]] = None,
                     block_slots: int = 0,
                     dtype_bytes: int = 2,
                     cache_row_bytes: Optional[float] = None
                     ) -> Tuple[int, int]:
    """(flops, bytes) of kernels 3 and 7: reads q and the keys and values
    each row sees (``common.decode_visible``: every key when `positions`
    are unknown), the two fp32 biases, writes the output; 4·Dh flops a
    (query head, key) pair. `block_slots` (r) places the rows' positions
    among the slots. `cache_row_bytes` is a key's bytes a head
    (kernel 7: Dh codes and a 4-byte scale; default Dh in the model
    dtype)."""
    vis = common.decode_visible(positions, batch=B, block_size=c,
                                block_slots=block_slots, slots=M)
    row = dtype_bytes * Dh if cache_row_bytes is None else cache_row_bytes
    nbytes = (dtype_bytes * 2 * B * Hkv * G * Dh + 2 * vis * Hkv * row
              + 4 * B * (c + M))
    return 4 * Dh * G * Hkv * vis, int(nbytes)


def launch_exact(kl: Optional[build.KernelLibrary], q, kbar, vbar, *,
                 scale: float, stream) -> torch.Tensor:
    """Check the operands, allocate the output and launch kernel 5 on
    `stream` (no synchronisation). q, k̄ and v̄ may be strided views (last
    dim contiguous); k̄ and v̄ share one stride set. `kl` None (the fake
    path) allocates and checks, and launches nothing."""
    B, H, S, Dh = q.shape
    Hkv, K = kbar.shape[1], kbar.shape[2]
    if kbar.shape != (B, Hkv, K, Dh) or vbar.shape != kbar.shape:
        raise ValueError(f"k̄/v̄ {tuple(kbar.shape)}/{tuple(vbar.shape)}: "
                         f"expected (B, Hkv, K, Dh) = {(B, Hkv, K, Dh)}")
    dtype = common.kernel_dtype_code(q, kbar, vbar)
    common.check_exact_shapes(heads=H, kv_heads=Hkv, slots=K, head_dim=Dh,
                              dtype=q.dtype)
    kbar, vbar = common.same_strides(kbar, vbar)
    out = torch.empty((B, H, S, Dh), dtype=q.dtype, device=q.device)
    common.check_operands(q, kbar, vbar, out)
    if kl is None:
        return out
    dims = (0, 1, 2)
    strides = build.strides_arg((q, dims), (kbar, dims), (out, dims))
    rc = kl.lib.linformer_attn_forward(
        q.data_ptr(), kbar.data_ptr(), vbar.data_ptr(), out.data_ptr(),
        strides, B, H, Hkv, S, K, Dh, float(scale), dtype, stream)
    kl.check(rc, "linformer_attn")
    return out


def linformer_attn(q, kbar, vbar, *, scale: float) -> torch.Tensor:
    """Exact Linformer attention in kernel layout. A CPU tensor runs the
    plain twin; a CUDA tensor launches kernel 5 on the current stream (or
    raises)."""
    if not q.is_cuda and not common.is_fake(q):
        return linformer_attn_plain(q, kbar, vbar, scale=scale)
    kl, stream = common.kernel_route(q)
    out = launch_exact(kl, q, kbar, vbar, scale=scale, stream=stream)
    if kl is not None:
        linformer_attn.launches += 1
    else:
        B, H, S, Dh = q.shape
        common.add_cost("linformer_attn", linformer_attn_cost(
            B, H, kbar.shape[1], S, kbar.shape[2], Dh,
            dtype_bytes=q.element_size()))
    return out


linformer_attn.launches = 0


def decode_attn_plain(q, raw_k, raw_v, comp_k, comp_v, bias_loc, bias_glob,
                      *, scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the TPU kernel's cast
    points (``_attend_pinned``): fp32 scores and products, the normalised
    probabilities cast to the value dtype before the value product, output
    cast to q's dtype."""
    f32 = torch.float32
    c = raw_k.shape[2]
    qf = q.to(f32)
    s_loc = torch.einsum("bhgd,bhkd->bhgk", qf, raw_k.to(f32)) * scale \
        + bias_loc.to(f32)[:, None, None, :]
    s_glob = torch.einsum("bhgd,bhmd->bhgm", qf, comp_k.to(f32)) * scale \
        + bias_glob.to(f32)[:, None, None, :]
    s = torch.cat([s_loc, s_glob], dim=-1)               # (B, Hkv, G, c + M)
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bhgk,bhkd->bhgd", p[..., :c].to(raw_v.dtype).to(f32),
                       raw_v.to(f32))
    out = out + torch.einsum("bhgm,bhmd->bhgd",
                             p[..., c:].to(comp_v.dtype).to(f32),
                             comp_v.to(f32))
    return out.to(q.dtype)


def decode_attn_q_plain(q, raw_k, raw_v, comp_k, comp_v, raw_k_s, raw_v_s,
                        comp_k_s, comp_v_s, bias_loc, bias_glob, *,
                        scale: float) -> torch.Tensor:
    """Plain PyTorch version of the quantized kernel (``_decode_kernel_q``):
    ring and slots dequantised to fp32, q cast to fp32, then the dense
    kernel's plain twin in fp32; the output cast to q's dtype."""
    out = decode_attn_plain(
        q.to(torch.float32), dequantize_blockwise(raw_k, raw_k_s),
        dequantize_blockwise(raw_v, raw_v_s),
        dequantize_blockwise(comp_k, comp_k_s),
        dequantize_blockwise(comp_v, comp_v_s), bias_loc, bias_glob,
        scale=scale)
    return out.to(q.dtype)


def launch(kl: Optional[build.KernelLibrary], q, raw_k, raw_v, comp_k,
           comp_v, bias_loc, bias_glob, *, scale: float, stream,
           scales=None) -> torch.Tensor:
    """Check the operands, allocate the output and launch the kernel on
    `stream` (no synchronisation). `scales`: None for a dense cache in q's
    dtype, or (raw_k_s, raw_v_s, comp_k_s, comp_v_s) fp32 for int8/fp8
    codes. `kl` None (the fake path) allocates and checks, and launches
    nothing."""
    B, Hkv, G, Dh = q.shape
    c, M = raw_k.shape[2], comp_k.shape[2]
    if raw_k.shape != (B, Hkv, c, Dh) or raw_v.shape != raw_k.shape:
        raise ValueError(f"ring {tuple(raw_k.shape)}/{tuple(raw_v.shape)}: "
                         f"expected (B, Hkv, c, Dh) = {(B, Hkv, c, Dh)}")
    if comp_k.shape != (B, Hkv, M, Dh) or comp_v.shape != comp_k.shape:
        raise ValueError(f"slots {tuple(comp_k.shape)}/{tuple(comp_v.shape)}"
                         f": expected (B, Hkv, M, Dh) = {(B, Hkv, M, Dh)}")
    if bias_loc.shape != (B, c) or bias_glob.shape != (B, M):
        raise ValueError(f"biases {tuple(bias_loc.shape)}, "
                         f"{tuple(bias_glob.shape)}: expected {(B, c)}, "
                         f"{(B, M)}")
    if bias_loc.dtype != torch.float32 or bias_glob.dtype != torch.float32:
        raise TypeError("decode biases must be float32")
    common.check_decode_shapes(group=G, head_dim=Dh)
    dtype = common.kernel_dtype_code(q)
    if scales is None:
        cache_dtype = common.kernel_dtype_code(q, raw_k, raw_v, comp_k,
                                               comp_v)
        rks = rvs = cks = cvs = None
    else:
        cache_dtype = common.storage_dtype_code(raw_k, raw_v, comp_k, comp_v)
        rks, rvs, cks, cvs = scales
        common.check_scales(raw_k, rks, rvs)
        common.check_scales(comp_k, cks, cvs)
        rks, rvs = common.same_strides(rks, rvs)
        cks, cvs = common.same_strides(cks, cvs)
        if any(s.device != q.device for s in scales):
            raise ValueError("scales and q on different devices")
    q = q.contiguous()
    bias_loc, bias_glob = bias_loc.contiguous(), bias_glob.contiguous()
    raw_k, raw_v = common.same_strides(raw_k, raw_v)
    comp_k, comp_v = common.same_strides(comp_k, comp_v)
    out = torch.empty_like(q)
    common.check_operands(q, raw_k, raw_v, comp_k, comp_v, bias_loc,
                          bias_glob, out)
    # the key splits and, for more than one, their fp32 merge states (o, m,
    # l) for the combine pass: scratch from the caching allocator, so the
    # launch can be captured into a CUDA graph
    nsplit, per_split = common.decode_splits(B * Hkv, G, c + M)
    part = None if nsplit == 1 else torch.empty(
        B * Hkv * nsplit * G * (Dh + 2), dtype=torch.float32,
        device=q.device)
    if kl is None:
        return out
    dims = (0, 1, 2)
    strides = build.strides_arg((raw_k, dims), (comp_k, dims), (rks, dims),
                                (cks, dims))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = kl.lib.decode_forward(
        q.data_ptr(), raw_k.data_ptr(), raw_v.data_ptr(), comp_k.data_ptr(),
        comp_v.data_ptr(), ptr(rks), ptr(rvs), ptr(cks), ptr(cvs),
        bias_loc.data_ptr(), bias_glob.data_ptr(), out.data_ptr(), ptr(part),
        strides, B, Hkv, G, Dh, c, M, nsplit, per_split, float(scale), dtype,
        cache_dtype, stream)
    kl.check(rc, "decode_attn")
    return out


def decode_attn(q, raw_k, raw_v, comp_k, comp_v, bias_loc, bias_glob, *,
                scale: float) -> torch.Tensor:
    """Decode attention in kernel layout. A CPU tensor runs the plain twin;
    a CUDA tensor launches the CUDA kernel on the current stream (or
    raises)."""
    if not q.is_cuda and not common.is_fake(q):
        return decode_attn_plain(q, raw_k, raw_v, comp_k, comp_v, bias_loc,
                                 bias_glob, scale=scale)
    kl, stream = common.kernel_route(q)
    out = launch(kl, q, raw_k, raw_v, comp_k, comp_v, bias_loc, bias_glob,
                 scale=scale, stream=stream)
    if kl is not None:
        decode_attn.launches += 1
    else:
        _fake_decode_cost("decode_attn", q, raw_k, comp_k, None)
    return out


def _fake_decode_cost(name, q, raw_k, comp_k, scales) -> None:
    """A fake decode launch's cost: every key seen (the biases' values are
    unknown)."""
    B, Hkv, G, Dh = q.shape
    row = None if scales is None else Dh * raw_k.element_size() + 4
    common.add_cost(name, decode_attn_cost(
        B, Hkv, G, Dh, raw_k.shape[2], comp_k.shape[2],
        dtype_bytes=q.element_size(), cache_row_bytes=row))


decode_attn.launches = 0


def decode_attn_q(q, raw_k, raw_v, comp_k, comp_v, raw_k_s, raw_v_s,
                  comp_k_s, comp_v_s, bias_loc, bias_glob, *,
                  scale: float) -> torch.Tensor:
    """Decode attention over the quantized cache, in kernel layout: q
    (B, Hkv, G, Dh) in the model dtype; ring (B, Hkv, c, Dh) and slots
    (B, Hkv, M, Dh) as int8/fp8 codes with fp32 scales (B, Hkv, c) and
    (B, Hkv, M), dequantised in the kernel. A CPU tensor runs the plain
    twin; a CUDA tensor launches the CUDA kernel (or raises)."""
    scales = (raw_k_s, raw_v_s, comp_k_s, comp_v_s)
    if not q.is_cuda and not common.is_fake(q):
        return decode_attn_q_plain(q, raw_k, raw_v, comp_k, comp_v, *scales,
                                   bias_loc, bias_glob, scale=scale)
    kl, stream = common.kernel_route(q)
    out = launch(kl, q, raw_k, raw_v, comp_k, comp_v, bias_loc, bias_glob,
                 scale=scale, scales=scales, stream=stream)
    if kl is not None:
        decode_attn_q.launches += 1
    else:
        _fake_decode_cost("decode_attn_q", q, raw_k, comp_k, scales)
    return out


decode_attn_q.launches = 0

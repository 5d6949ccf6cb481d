"""Single-token decode attention over the compressed cache: the CUDA
kernel's wrapper and its plain PyTorch twin.

Counterpart of ``decode_attn`` in ``repro/kernels/linformer_attn.py``.
Kernel layout: q (B, Hkv, G, Dh) with the GQA group folded into the query
axis; ring (B, Hkv, c, Dh); slots (B, Hkv, M, Dh); additive fp32 biases
(B, c) and (B, M), 0 for attendable and NEG_INF for masked. Per (b, kv head)
the G query rows take one softmax over [ring | slots].

``decode_attn`` runs the plain twin for a CPU tensor and the CUDA kernel
(``csrc/decode_attn.cu``) for a CUDA tensor, counting its launches in
``decode_attn.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import common


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


def launch(kl: build.KernelLibrary, q, raw_k, raw_v, comp_k, comp_v,
           bias_loc, bias_glob, *, scale: float, stream) -> torch.Tensor:
    """Check the operands, allocate the output and launch the kernel on
    `stream` (no synchronisation)."""
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
    dtype = common.kernel_dtype_code(q, raw_k, raw_v, comp_k, comp_v)
    q = q.contiguous()
    bias_loc, bias_glob = bias_loc.contiguous(), bias_glob.contiguous()
    if raw_k.stride() != raw_v.stride():
        raw_k, raw_v = raw_k.contiguous(), raw_v.contiguous()
    if comp_k.stride() != comp_v.stride():
        comp_k, comp_v = comp_k.contiguous(), comp_v.contiguous()
    out = torch.empty_like(q)
    common.check_operands(q, raw_k, raw_v, comp_k, comp_v, bias_loc,
                          bias_glob, out)
    dims = (0, 1, 2)
    strides = build.strides_arg((raw_k, dims), (comp_k, dims))
    rc = kl.lib.decode_forward(
        q.data_ptr(), raw_k.data_ptr(), raw_v.data_ptr(), comp_k.data_ptr(),
        comp_v.data_ptr(), bias_loc.data_ptr(), bias_glob.data_ptr(),
        out.data_ptr(), strides, B, Hkv, G, Dh, c, M, float(scale), dtype,
        stream)
    kl.check(rc, "decode_attn")
    return out


def decode_attn(q, raw_k, raw_v, comp_k, comp_v, bias_loc, bias_glob, *,
                scale: float) -> torch.Tensor:
    """Decode attention in kernel layout. A CPU tensor runs the plain twin;
    a CUDA tensor launches the CUDA kernel on the current stream (or
    raises)."""
    if not q.is_cuda:
        return decode_attn_plain(q, raw_k, raw_v, comp_k, comp_v, bias_loc,
                                 bias_glob, scale=scale)
    out = launch(build.library(), q, raw_k, raw_v, comp_k, comp_v, bias_loc,
                 bias_glob, scale=scale,
                 stream=torch.cuda.current_stream(q.device).cuda_stream)
    decode_attn.launches += 1
    return out


decode_attn.launches = 0

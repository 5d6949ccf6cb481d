"""Sequence projection of the exact Linformer form, K̄ = Eᵀ·x: the CUDA
kernel's wrapper and its plain PyTorch twin.

Counterpart of ``repro/kernels/seq_projection.py`` (kernel 6,
``csrc/seq_projection.cu``). Kernel layout: x (B, H, S, Dh) the keys or
values, in any (batch, head, seq) strides; E (S, K) one shared projection
(the model passes the leading-row view E[:S] of its (max_seq, K) E);
out (B, H, K, Dh) in x's dtype, summed in fp32.

The wrapper runs the plain twin for a CPU tensor and the CUDA kernel for a
CUDA tensor, counting its launches in ``seq_projection.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import common


def seq_projection_plain(x, E) -> torch.Tensor:
    """Plain PyTorch version of the kernel: fp32 products and sum (the TPU
    kernel's fp32 accumulator), output cast to x's dtype."""
    out = torch.einsum("sk,bhsd->bhkd", E.to(torch.float32),
                       x.to(torch.float32))
    return out.to(x.dtype)


def launch(kl: build.KernelLibrary, x, E, *, stream) -> torch.Tensor:
    """Check the operands, allocate the output and launch the kernel on
    `stream` (no synchronisation)."""
    B, H, S, Dh = x.shape
    if E.ndim != 2:
        raise ValueError(f"E {tuple(E.shape)}: the kernel takes one shared "
                         "(S, K) projection")
    K = E.shape[1]
    dtype = common.kernel_dtype_code(x, E)
    common.check_seq_projection_shapes(seq=S, rows=E.shape[0], slots=K,
                                       head_dim=Dh, dtype=x.dtype)
    out = torch.empty((B, H, K, Dh), dtype=x.dtype, device=x.device)
    common.check_operands(x, E, out)
    strides = build.strides_arg((x, (0, 1, 2)), (E, (0,)), (out, (0, 1, 2)))
    rc = kl.lib.seq_projection_forward(x.data_ptr(), E.data_ptr(),
                                       out.data_ptr(), strides, B, H, S, K,
                                       Dh, dtype, stream)
    kl.check(rc, "seq_projection")
    return out


def seq_projection(x, E) -> torch.Tensor:
    """K̄ = Eᵀ·x in kernel layout. A CPU tensor runs the plain twin; a CUDA
    tensor launches the kernel on the current stream (or raises)."""
    if not x.is_cuda:
        return seq_projection_plain(x, E)
    out = launch(build.library(), x, E,
                 stream=torch.cuda.current_stream(x.device).cuda_stream)
    seq_projection.launches += 1
    return out


seq_projection.launches = 0

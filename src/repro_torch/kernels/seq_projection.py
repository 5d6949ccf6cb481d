"""Sequence projection of the exact Linformer form, K̄ = Eᵀ·x: the CUDA
kernel's wrapper and its plain PyTorch twin.

Counterpart of ``repro/kernels/seq_projection.py`` (kernel 6,
``csrc/seq_projection.cu``). Kernel layout: x (B, H, S, Dh) the keys or
values, in any (batch, head, seq) strides; E (S, K) one shared projection
(the model passes the leading-row view E[:S] of its (max_seq, K) E);
out (B, H, K, Dh) in x's dtype, summed in fp32.

The wrapper runs the plain twin for a CPU tensor and the CUDA kernel for a
CUDA tensor, counting its launches in ``seq_projection.launches``;
FakeTensor operands take the fake path (``common.is_fake``: the launch's
allocation and checks, no kernel and no counter moved,
``seq_projection_cost`` to ``common.add_cost``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import common


def seq_projection_plain(x, E) -> torch.Tensor:
    """Plain PyTorch version of the kernel: fp32 products and sum (the TPU
    kernel's fp32 accumulator), output cast to x's dtype."""
    out = torch.einsum("sk,bhsd->bhkd", E.to(torch.float32),
                       x.to(torch.float32))
    return out.to(x.dtype)


def seq_projection_cost(B: int, H: int, S: int, K: int, Dh: int, *,
                        dtype_bytes: int = 2) -> Tuple[int, int]:
    """(flops, bytes) of kernel 6: reads x and E[:S], writes K̄; 2·Dh flops
    a (row, slot) pair."""
    return (2 * S * K * Dh * B * H,
            dtype_bytes * (B * H * S * Dh + S * K + B * H * K * Dh))


def launch(kl: Optional[build.KernelLibrary], x, E, *, stream
           ) -> torch.Tensor:
    """Check the operands, allocate the output and launch the kernel on
    `stream` (no synchronisation). `kl` None (the fake path) allocates
    and checks, and launches nothing."""
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
    if kl is None:
        return out
    strides = build.strides_arg((x, (0, 1, 2)), (E, (0,)), (out, (0, 1, 2)))
    rc = kl.lib.seq_projection_forward(x.data_ptr(), E.data_ptr(),
                                       out.data_ptr(), strides, B, H, S, K,
                                       Dh, dtype, stream)
    kl.check(rc, "seq_projection")
    return out


def seq_projection(x, E) -> torch.Tensor:
    """K̄ = Eᵀ·x in kernel layout. A CPU tensor runs the plain twin; a CUDA
    tensor launches the kernel on the current stream (or raises)."""
    if not x.is_cuda and not common.is_fake(x):
        return seq_projection_plain(x, E)
    kl, stream = common.kernel_route(x)
    out = launch(kl, x, E, stream=stream)
    if kl is not None:
        seq_projection.launches += 1
    else:
        B, H, S, Dh = x.shape
        common.add_cost("seq_projection", seq_projection_cost(
            B, H, S, E.shape[1], Dh, dtype_bytes=x.element_size()))
    return out


seq_projection.launches = 0

"""Sequence-axis projection operators (the E/F of the paper, Eq. 7).

Counterpart of ``repro/core/projections.py``. Three families (the paper's
§4 "General projections"):

* ``linear`` — dense learned E ∈ R^{n×k}; K̄ = EᵀK. The paper's default.
* ``conv``   — 1-D convolution along the sequence with kernel = stride = c,
               r learned output slots per window: a block-diagonal E with
               shared blocks.
* ``pool``   — mean pooling with kernel = stride = c (parameter-free).

Shape conventions: sequence tensors are (B, S, H, Dh); projections act on S.
"""
from __future__ import annotations

import torch


def linear_project(x: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """Dense sequence projection K̄ = EᵀK (paper Eq. 7).

    x: (B, S, H, Dh); E: (S, K) shared across heads, or (H, S, K) per head.
    Returns (B, K, H, Dh)."""
    if E.ndim == 2:
        return torch.einsum("bshd,sk->bkhd", x, E.to(x.dtype))
    if E.ndim == 3:
        return torch.einsum("bshd,hsk->bkhd", x, E.to(x.dtype))
    raise ValueError(f"E must be (S,K) or (H,S,K), got {tuple(E.shape)}")


def blockwise_project(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Conv-style projection: kernel = stride = c, r output slots per window.

    x: (B, S, H, Dh) with S % c == 0; W: (c, r) shared across heads, or
    (H, c, r) per head. Returns (B, (S//c)·r, H, Dh), window-major."""
    per_head = W.ndim == 3
    c, r = (W.shape[1], W.shape[2]) if per_head else (W.shape[0], W.shape[1])
    B, S, H, Dh = x.shape
    if S % c != 0:
        raise ValueError(f"seq len {S} not divisible by block size {c}")
    nb = S // c
    xb = x.reshape(B, nb, c, H, Dh)
    if per_head:
        out = torch.einsum("bnchd,hcr->bnrhd", xb, W.to(x.dtype))
    else:
        out = torch.einsum("bnchd,cr->bnrhd", xb, W.to(x.dtype))
    return out.reshape(B, nb * r, H, Dh)


def pool_weights(c: int, r: int = 1, dtype=torch.float32) -> torch.Tensor:
    """Mean-pool projection weights: each of r slots averages a c/r
    sub-window."""
    if c % r != 0:
        raise ValueError(f"block {c} not divisible by slots {r}")
    sub = c // r
    w = torch.zeros((c, r), dtype=dtype)
    for j in range(r):
        w[j * sub:(j + 1) * sub, j] = 1.0 / sub
    return w


def conv_as_linear(W: torch.Tensor, n: int) -> torch.Tensor:
    """The block-diagonal E ∈ R^{n×k} equivalent to a blockwise projection:
    the conv variant as a special case of the paper's linear E."""
    c, r = W.shape
    if n % c != 0:
        raise ValueError(f"n={n} not divisible by block size {c}")
    nb = n // c
    E = torch.zeros((n, nb * r), dtype=W.dtype, device=W.device)
    for b in range(nb):
        E[b * c:(b + 1) * c, b * r:(b + 1) * r] = W
    return E


def effective_k(k: int, k_decay: float, layer_idx: int,
                num_layers: int) -> int:
    """Non-uniform projected dimension (paper §4): linear interpolation from
    k at layer 0 to ceil(k · k_decay) at the last layer, floored at 1."""
    if num_layers <= 1 or k_decay >= 1.0:
        return k
    frac = layer_idx / (num_layers - 1)
    kk = k * (1.0 - (1.0 - k_decay) * frac)
    return max(1, int(-(-kk // 1)))  # ceil

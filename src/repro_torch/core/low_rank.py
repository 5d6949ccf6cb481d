"""Spectrum analysis of the context-mapping matrix P (paper §3, Figure 1)
and empirical checks of the JL approximation (Theorems 1–2).

Counterpart of ``repro/core/low_rank.py``. The functions take one head, as
the JAX ones do, and also a leading batch of heads (``(..., S, Dh)``, the
spectrum per matrix), so the card computes every layer's heads in one SVD
call. The two random functions draw R ∈ R^{k×n}, entries N(0, 1/k), from
an explicit ``torch.Generator``; their ``*_given_r`` helpers take R, so a
test can feed them the JAX package's own R.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def context_mapping(q: torch.Tensor, k: torch.Tensor, *,
                    scale: Optional[float] = None,
                    causal: bool = False) -> torch.Tensor:
    """P = softmax(QKᵀ/√d). q, k: (..., S, Dh) -> (..., S, S); the product
    in the inputs' dtype, then fp32."""
    S, Dh = q.shape[-2:]
    scale_ = scale if scale is not None else Dh ** -0.5
    a = (q @ k.transpose(-1, -2)).to(torch.float32) * scale_
    if causal:
        tril = torch.ones((S, S), dtype=torch.bool, device=q.device).tril_()
        a = a.masked_fill(~tril, -1e30)
    return torch.softmax(a, dim=-1)


def cumulative_spectrum(P: torch.Tensor) -> torch.Tensor:
    """Normalized cumulative singular values of P (Figure 1, Y-axis):
    (..., S) monotone in [0, 1], out[i] = sum(sigma[:i+1]) / sum(sigma)."""
    s = torch.linalg.svdvals(P.to(torch.float32))
    c = torch.cumsum(s, dim=-1)
    return c / c[..., -1:]


def energy_at_rank(P: torch.Tensor, rank: int) -> torch.Tensor:
    """Figure 1 (right): cumulative singular-value mass at a given rank."""
    return cumulative_spectrum(P)[..., rank - 1]


def rank_for_energy(P: torch.Tensor, energy: float = 0.9) -> torch.Tensor:
    """Smallest rank capturing `energy` of the spectrum mass."""
    spec = cumulative_spectrum(P)
    return torch.argmax((spec >= energy).to(torch.int32), dim=-1) + 1


def _draw_r(generator: torch.Generator, k: int, n: int,
            device: torch.device) -> torch.Tensor:
    return torch.randn((k, n), generator=generator, dtype=torch.float32,
                       device=device) / math.sqrt(k)


def jl_projection_error_given_r(P: torch.Tensor, w: torch.Tensor,
                                R: torch.Tensor) -> torch.Tensor:
    """||P RᵀR w − P w|| / ||P w|| for a given R (k, n)."""
    ref = P @ w
    approx = P @ (R.T @ (R @ w))
    return torch.linalg.norm(approx - ref) / torch.clamp(
        torch.linalg.norm(ref), min=1e-30)


def jl_projection_error(generator: torch.Generator, P: torch.Tensor,
                        w: torch.Tensor, k: int) -> torch.Tensor:
    """Relative error of the Theorem-1 construction, R ∈ R^{k×n} with
    entries N(0, 1/k) drawn from `generator`."""
    R = _draw_r(generator, k, P.shape[0], P.device)
    return jl_projection_error_given_r(P, w, R)


def theorem2_error_given_r(a_row: torch.Tensor, V: torch.Tensor,
                           R: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error of softmax(w Eᵀ) F V against softmax(w) V with E = δR,
    F = e^{-δ}R (δ = 1/n) for a given R (k, n). a_row: (n,) one row of
    QKᵀ/√d; V: (n, d). Returns (error, reference norm)."""
    n = a_row.shape[0]
    delta = 1.0 / n
    E = delta * R            # (k, n): Eᵀ in the paper's notation
    F = math.exp(-delta) * R
    ref = torch.softmax(a_row, dim=-1) @ V
    approx = torch.softmax(a_row @ E.T, dim=-1) @ (F @ V)
    return torch.linalg.norm(approx - ref), torch.linalg.norm(ref)


def theorem2_error(generator: torch.Generator, a_row: torch.Tensor,
                   V: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Theorem 2's relative-error construction with R drawn from
    `generator`; see :func:`theorem2_error_given_r`."""
    R = _draw_r(generator, k, a_row.shape[0], a_row.device)
    return theorem2_error_given_r(a_row, V, R)

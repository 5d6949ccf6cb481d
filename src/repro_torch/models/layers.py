"""Shared layers as plain functions on tensors: norms, rotary embeddings,
the MLP, embedding lookup.

Counterpart of ``repro/models/layers.py``; parameters are nested dicts of
tensors, with the JAX package's (in, out) weight orientation (``x @ w``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as Fn

from repro_torch.configs.base import MLPConfig
from repro_torch.parallel import comm


def rms_norm(params: Dict, x: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm in fp32, cast back to x's dtype. eps is 1e-6 whatever the
    config's norm_eps says, exactly as in the JAX package."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(dt)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """NeoX half rotation in fp32. x: (B, S, H, Dh); positions: (S,) or
    (B, S)."""
    Dh = x.shape[-1]
    freqs = rope_frequencies(Dh, theta, x.device)        # (Dh/2,)
    ang = positions.to(torch.float32)[..., None] * freqs  # (S|B,S, Dh/2)
    if positions.ndim == 1:
        ang = ang[None, :, None, :]                      # (1, S, 1, Dh/2)
    else:
        ang = ang[:, :, None, :]                         # (B, S, 1, Dh/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mlp(params: Dict, x: torch.Tensor, cfg: MLPConfig, tp=None
              ) -> torch.Tensor:
    """The MLP of the stream x (..., D). With `tp` (the model dim's Axis,
    parallel/sharding.tensor_axis) the weights are this rank's shards,
    Megatron-style: ``w_in``/``w_gate`` column-parallel (x enters through
    ``comm.copy``, whose backward sums the input gradient over the model
    dim), the activation on the local columns, ``w_out`` row-parallel,
    the partial outputs summed over the model dim (``comm.reduce``)."""
    x = comm.copy(x, (tp,))
    h = x @ params["w_in"]
    if cfg.activation == "swiglu":
        h = Fn.silu(x @ params["w_gate"]) * h
    elif cfg.activation == "squared_relu":
        h = torch.square(torch.relu(h))
    elif cfg.activation == "gelu":
        h = Fn.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {cfg.activation!r}")
    return comm.reduce(h @ params["w_out"], (tp,))


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]

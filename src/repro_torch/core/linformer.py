"""Linformer E/F projection parameters (causal form).

Counterpart of ``init_linformer_params`` in ``repro/core/linformer.py`` for
``kind="linformer_causal"``: E/F are the blockwise (conv) projection weights
of shape (c, r) — or (Hkv, c, r) when nothing is shared — under the paper's
four sharing strategies:

  * none      — distinct E, F per layer and per kv head
  * headwise  — per layer: one E and one F shared across heads
  * kv        — per layer: a single E = F
  * layerwise — one E = F for the whole network

Layout, as in the JAX package: ``{"shared": {"E"}}`` (no layer axis) or
``{"per_layer": {"E"[, "F"]}}`` with a leading layer axis.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import AttentionConfig


def ef_shape(cfg: AttentionConfig) -> Tuple[int, ...]:
    lin = cfg.linformer
    n, k = lin.block_size, lin.block_slots
    if lin.sharing == "none":
        return (cfg.num_kv_heads, n, k)
    return (n, k)


def linformer_param_shapes(cfg: AttentionConfig, *, num_layers: int
                           ) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Shapes of the E/F leaves, grouped like `init_linformer_params`."""
    if cfg.kind != "linformer_causal":
        raise ValueError("the PyTorch port covers kind='linformer_causal' "
                         f"only, got {cfg.kind!r}")
    shape = ef_shape(cfg)
    sharing = cfg.linformer.sharing
    if sharing == "layerwise":
        return {"shared": {"E": shape}}
    if sharing == "kv":
        return {"per_layer": {"E": (num_layers,) + shape}}
    if sharing in ("headwise", "none"):
        return {"per_layer": {"E": (num_layers,) + shape,
                              "F": (num_layers,) + shape}}
    raise ValueError(f"unknown sharing mode {sharing!r}")


def init_linformer_params(generator: torch.Generator, cfg: AttentionConfig,
                          *, num_layers: int, device: torch.device,
                          dtype=torch.float32) -> Dict:
    """Create E/F per the configured sharing mode: JL-style N(0, 1/r), so
    projected keys keep the scale of raw keys."""
    std = cfg.linformer.block_slots ** -0.5
    return {group: {name: torch.randn(shape, generator=generator,
                                      device=device).mul_(std).to(dtype)
                    for name, shape in leaves.items()}
            for group, leaves in linformer_param_shapes(
                cfg, num_layers=num_layers).items()}

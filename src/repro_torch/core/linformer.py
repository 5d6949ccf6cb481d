"""Linformer E/F projection parameters and the exact (bidirectional) form.

Counterpart of ``repro/core/linformer.py``. The E/F leaves follow
``AttentionConfig.kind`` (the standard softmax baseline, ``"standard"``, has
none):

* ``"linformer"`` (the paper's exact form, Eq. 7): E/F ∈ R^{n×k} with
  n = max_seq, shape (max_seq, k), or (Hkv, max_seq, k) when nothing is
  shared;
* ``"linformer_causal"``: the blockwise (conv) projection weights (c, r),
  or (Hkv, c, r) when nothing is shared;

under the paper's four sharing strategies:

  * none      — distinct E, F per layer and per kv head
  * headwise  — per layer: one E and one F shared across heads
  * kv        — per layer: a single E = F
  * layerwise — one E = F for the whole network

Layout, as in the JAX package: ``{"shared": {"E"}}`` (no layer axis) or
``{"per_layer": {"E"[, "F"]}}`` with a leading layer axis.

The exact form computes, per head i,
``softmax(q (E_i k)ᵀ / √d) · (F_i v)``: :func:`project_kv` compresses the
sequence axis and :func:`attend_compressed` attends over the K slots;
:func:`exact_linformer_attention` is both, the reference route and the
kernels' oracle.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.core import projections as proj

KINDS = ("standard", "linformer", "linformer_causal")
LINFORMER_KINDS = KINDS[1:]


def check_kind(cfg: AttentionConfig) -> None:
    if cfg.kind not in KINDS:
        raise ValueError(f"unknown attention kind {cfg.kind!r} (expected "
                         f"one of {KINDS})")


def uses_linformer(cfg: AttentionConfig) -> bool:
    """Whether the kind has E/F parameters (every kind but the standard
    baseline)."""
    check_kind(cfg)
    return cfg.kind in LINFORMER_KINDS


def ef_shape(cfg: AttentionConfig, *, max_seq: int) -> Tuple[int, ...]:
    """Shape of one layer's E (or F): (n, k) or, with sharing "none",
    (Hkv, n, k); n, k = (max_seq, k) for the exact form, (c, r) for the
    causal one."""
    check_kind(cfg)
    lin = cfg.linformer
    if cfg.kind == "linformer_causal":
        n, k = lin.block_size, lin.block_slots
    else:
        n, k = max_seq, lin.k
    if lin.sharing == "none":
        return (cfg.num_kv_heads, n, k)
    return (n, k)


def linformer_param_shapes(cfg: AttentionConfig, *, num_layers: int,
                           max_seq: int
                           ) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Shapes of the E/F leaves, grouped as ``{"shared": {"E"}}`` or
    ``{"per_layer": {"E"[, "F"]}}`` (leading layer axis); empty for the
    standard baseline."""
    if not uses_linformer(cfg):
        return {}
    shape = ef_shape(cfg, max_seq=max_seq)
    sharing = cfg.linformer.sharing
    if sharing == "layerwise":
        return {"shared": {"E": shape}}
    if sharing == "kv":
        return {"per_layer": {"E": (num_layers,) + shape}}
    if sharing in ("headwise", "none"):
        return {"per_layer": {"E": (num_layers,) + shape,
                              "F": (num_layers,) + shape}}
    raise ValueError(f"unknown sharing mode {sharing!r}")


def init_linformer_params(generator: torch.Generator,
                          shapes: Dict[str, Tuple[int, ...]], *,
                          device: torch.device, dtype=torch.float32
                          ) -> Dict[str, torch.Tensor]:
    """Draw the E/F leaves {key: shape}, in order: JL-style N(0, 1/k), k =
    shape[-1] the projected length (lin.k, or a layer's effective_k, for
    the exact form; r for the causal one), so projected keys keep the scale
    of raw keys. models/transformer.py ``init_params`` passes the E/F
    leaves of its ``param_spec``."""
    return {key: torch.randn(shape, generator=generator, device=device)
            .mul_(shape[-1] ** -0.5).to(dtype)
            for key, shape in shapes.items()}


def num_projection_matrices(cfg: AttentionConfig, num_layers: int) -> int:
    """Distinct projection matrices implied by the sharing mode — paper §4:
    12L/12H gives headwise=24, kv=12, layerwise=1."""
    sharing = cfg.linformer.sharing
    if sharing == "layerwise":
        return 1
    if sharing == "kv":
        return num_layers
    if sharing == "headwise":
        return 2 * num_layers
    return 2 * num_layers * cfg.num_kv_heads


def resolve_ef(lin_params: Dict, layer_slice: Optional[Dict]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E, F) of one layer given the param layout: the shared E for both
    under layerwise sharing, else the layer's E and its F (E when absent).
    `layer_slice` is the per-layer entry with the layer axis indexed away."""
    if "shared" in lin_params:
        E = lin_params["shared"]["E"]
        return E, E
    if layer_slice is None:
        raise ValueError("per-layer params need a layer slice")
    E = layer_slice["E"]
    return E, layer_slice.get("F", E)


# ---------------------------------------------------------------------------
# Exact (bidirectional) Linformer attention — paper Eq. 7
# ---------------------------------------------------------------------------


def check_projection_rows(seq: int, E: torch.Tensor) -> None:
    """A linear E is stored for max_seq rows; a batch longer than that has
    positions E does not cover."""
    if E.shape[-2] < seq:
        raise ValueError(
            f"sequence length {seq} exceeds the {E.shape[-2]} rows of the "
            "Linformer projection E (stored for the config's max_seq_len); "
            "shorten the sequence or raise max_seq_len")


def project_kv(k: torch.Tensor, v: torch.Tensor, E: torch.Tensor,
               F: torch.Tensor, *, kind: str = "linear"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress the sequence axis of K and V.

    k, v: (B, S, Hkv, Dh). E/F per `kind`: linear (S', K) or (Hkv, S', K)
    with S' ≥ S (rows past the batch's S are dropped: positions that do not
    exist contribute nothing); conv/pool (c, r) blockwise weights.
    Returns (B, K, Hkv, Dh) compressed keys/values."""
    if kind == "linear":
        S = k.shape[1]
        check_projection_rows(S, E)
        check_projection_rows(S, F)
        return (proj.linear_project(k, E[..., :S, :]),
                proj.linear_project(v, F[..., :S, :]))
    if kind in ("conv", "pool"):
        return proj.blockwise_project(k, E), proj.blockwise_project(v, F)
    raise ValueError(f"unknown projection kind {kind!r}")


def attend_compressed(q: torch.Tensor, kbar: torch.Tensor,
                      vbar: torch.Tensor, *, scale: Optional[float] = None
                      ) -> torch.Tensor:
    """softmax(q·k̄ᵀ/√d)·v̄ with GQA-grouped heads: fp32 scores, the
    probabilities cast to q's dtype before the value product.

    q: (B, S, H, Dh); kbar/vbar: (B, K, Hkv, Dh); H % Hkv == 0.
    Returns (B, S, H, Dh)."""
    B, S, H, Dh = q.shape
    Hkv = kbar.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else Dh ** -0.5
    qg = q.reshape(B, S, Hkv, G, Dh)
    s = torch.einsum("bshgd,bkhd->bhgsk", qg, kbar).to(torch.float32) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhgsk,bkhd->bshgd", p, vbar)
    return out.reshape(B, S, H, Dh)


def exact_linformer_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, E: torch.Tensor,
                              F: torch.Tensor, *, kind: str = "linear",
                              scale: Optional[float] = None) -> torch.Tensor:
    """The paper's linear self-attention (Eq. 7), bidirectional: project_kv,
    then attend_compressed."""
    kbar, vbar = project_kv(k, v, E, F, kind=kind)
    return attend_compressed(q, kbar, vbar, scale=scale)

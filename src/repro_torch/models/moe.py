"""Mixture-of-Experts feed-forward with capacity-based dispatch, on one
device.

Counterpart of ``repro/models/moe.py`` (``init_moe``, ``_capacity``,
``_expert_ffn``, ``_moe_local`` and the unsharded branch of ``apply_moe``).
Each token picks its top-k experts by router probability; expert e keeps
at most C = capacity(T) tokens, in row-major token order over the whole
flattened (B·S) batch, and drops the rest, so one row's output depends on
every other row of the same call. The expert-parallel paths of the JAX
module (the shard_map branch and ``_moe_weight_stationary``) need a mesh
and are not ported.

The routing is JAX's to the bit where fp32 allows: the router runs in fp32
whatever the model dtype, ties between equal probabilities go to the lower
expert index (``jax.lax.top_k``'s order; a stable descending sort), and a
token's slot in an expert is its rank among the expert's tokens. Dispatch
and combine never build an (E, T, D) tensor: each (token, choice) pair
writes its token to a unique (expert, slot) row, or to one overflow row
that is thrown away, and the combine gathers each token's ≤ k expert
outputs, scales them by the renormalised weight (cast to the output dtype,
as JAX casts it) and sums them in ascending expert order. The forward's
only atomics count the experts' loads in integers, so it is deterministic
on the card.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as Fn

from repro_torch.configs.base import MLPConfig, MoEConfig


def moe_param_shapes(d_model: int, cfg: MoEConfig, mlp: MLPConfig,
                     dtype: torch.dtype
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """One layer's {leaf: (shape, dtype)}: the router (D, E) in fp32
    whatever the model `dtype`, the experts' (E, D, ff) w_in and w_gate
    (swiglu only) and (E, ff, D) w_out in `dtype`. All are fan-in normal
    with shape[-2] as the fan-in (JAX's ``init_moe``)."""
    E, ff = cfg.num_experts, cfg.expert_d_ff
    shapes = {"router": ((d_model, E), torch.float32),
              "w_in": ((E, d_model, ff), dtype),
              "w_out": ((E, ff, d_model), dtype)}
    if mlp.activation == "swiglu":
        shapes["w_gate"] = ((E, d_model, ff), dtype)
    return shapes


def capacity(tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert keeps for a call over `tokens` tokens: the top-k
    share of the tokens times capacity_factor, at least 1 (or top_k with
    ``capacity_floor_one=False``)."""
    c = int(tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    floor = 1 if cfg.capacity_floor_one else cfg.top_k
    return max(floor, c)


def expert_ffn(w_in: torch.Tensor, w_gate: Optional[torch.Tensor],
               w_out: torch.Tensor, x: torch.Tensor, activation: str
               ) -> torch.Tensor:
    """x: (E, C, D) -> (E, C, D), each expert's MLP over its slots."""
    h = torch.bmm(x, w_in)
    if activation == "swiglu":
        h = Fn.silu(torch.bmm(x, w_gate)) * h
    elif activation == "squared_relu":
        h = torch.square(torch.relu(h))
    elif activation == "gelu":
        h = Fn.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return torch.bmm(h, w_out)


def route(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig
          ) -> Dict[str, torch.Tensor]:
    """Routing of tokens x (T, D) over the experts of `router` (D, E):

    * ``top_i`` (T, k) chosen experts, by the fp32 softmax of the fp32
      router logits, ties to the lower index; ``top_w`` (T, k) their
      probabilities renormalised to sum 1;
    * ``slot`` (T, k) each choice's rank among its expert's tokens (row-
      major token order) and ``keep`` (T, k) whether it is within the
      capacity C = capacity(T);
    * ``aux``: the Switch load-balance loss E · Σ_e f_e · p_e, f_e the
      share of the T·k choices on expert e, p_e its mean probability."""
    T = x.shape[0]
    E, K = router.shape[1], cfg.top_k
    C = capacity(T, cfg)
    logits = x.to(torch.float32) @ router
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :K], top_i[:, :K]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    counts = torch.bincount(top_i.reshape(-1), minlength=E)
    aux = E * torch.sum(probs.mean(0) * (counts.to(torch.float32)
                                         / (T * K)))
    chosen = torch.zeros((T, E), dtype=torch.int32, device=x.device)
    chosen.scatter_(1, top_i, 1)
    slot = (torch.cumsum(chosen, dim=0) - 1).gather(1, top_i)
    return {"top_i": top_i, "top_w": top_w, "slot": slot, "keep": slot < C,
            "aux": aux, "capacity": C}


def moe_local(router: torch.Tensor, w_in: torch.Tensor,
              w_gate: Optional[torch.Tensor], w_out: torch.Tensor,
              x: torch.Tensor, *, cfg: MoEConfig, activation: str
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route tokens x (T, D) to every expert. Returns (out (T, D), aux)."""
    T, D = x.shape
    E, K = w_in.shape[0], cfg.top_k
    r = route(router, x, cfg)
    C = r["capacity"]
    # order each token's choices by expert index: the combine then sums in
    # JAX's order (a sum over e = 0..E-1 of zeros and the kept outputs)
    top_i, order = torch.sort(r["top_i"], dim=-1)
    top_w, slot, keep = (r[k].gather(1, order)
                         for k in ("top_w", "slot", "keep"))
    # row e·C + slot of the (E·C + 1, D) buffer, or the overflow row E·C
    dest = torch.where(keep, top_i * C + slot,
                       torch.full_like(top_i, E * C)).reshape(-1)
    tok = torch.arange(T, device=x.device).repeat_interleave(K)
    buf = x.new_zeros((E * C + 1, D)).index_copy(0, dest, x[tok])
    y = expert_ffn(w_in, w_gate, w_out, buf[:E * C].view(E, C, D),
                   activation)
    y = torch.cat([y.reshape(E * C, D), y.new_zeros((1, D))])
    w = (top_w * keep).to(y.dtype)
    out = (y[dest].view(T, K, D) * w[..., None]).sum(1)
    return out, r["aux"]


def apply_moe(params: Dict, x: torch.Tensor, cfg: MoEConfig,
              mlp: MLPConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over x (B, S, D), the B·S tokens routed together. Returns
    (out (B, S, D), aux scalar fp32)."""
    B, S, D = x.shape
    out, aux = moe_local(params["router"], params["w_in"],
                         params.get("w_gate"), params["w_out"],
                         x.reshape(B * S, D), cfg=cfg,
                         activation=mlp.activation)
    return out.view(B, S, D), aux

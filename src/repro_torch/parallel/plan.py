"""Attention execution plan, single device.

Counterpart of the single-device half of ``repro/parallel/plan.py``: ONE
place decides how attention executes, so call sites (models/attention.py,
core/cache.py, the serving engine) never branch on backend strings. The
knob is the JAX package's ``AttentionConfig.backend``:

* ``"auto"`` (default): the CUDA kernels for CUDA tensors, their plain twins
  for CPU tensors (through kernels/ops.py);
* ``"fused"``: the CUDA kernels; raises for CPU tensors;
* ``"reference"``: the plain reference forms of core/causal.py and
  core/linformer.py, on any device (the parity oracle).

Every route of the full-sequence and chunk-prefill forms is
differentiable; the quantized-cache forms are forward-only (serving). On
the kernel route the training backward follows
``AttentionConfig.backward_impl``:
``"fused"`` (default) runs the backward kernel from the forward's saved
residuals, ``"reference"`` autograd through the plain reference form
(kernels/ops.py).

The multi-device plans (tensor and sequence parallelism) come with the
multi-GPU slice.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.core import causal as causal_lib
from repro_torch.core import linformer as lin_lib
from repro_torch.core.cache import dequantize_blockwise
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.common import backend_route, backward_route


def decode_biases(loc_ok: torch.Tensor, glob_ok: torch.Tensor):
    """Boolean validity masks -> the decode kernel's additive fp32 biases
    (0 attendable, NEG_INF masked)."""
    zero = torch.zeros((), dtype=torch.float32, device=loc_ok.device)
    neg = torch.full((), causal_lib.NEG_INF, dtype=torch.float32,
                     device=loc_ok.device)
    return torch.where(loc_ok, zero, neg), torch.where(glob_ok, zero, neg)


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """Execution plan for the attention forms of one config."""

    backend: str = "auto"            # AttentionConfig.backend knob
    backward_impl: str = "fused"     # AttentionConfig.backward_impl knob

    def __post_init__(self):
        backend_route(self.backend, True)     # raise on an unknown knob
        backward_route(self.backward_impl)

    def uses_kernels(self, x: torch.Tensor) -> bool:
        """Whether a call on `x` goes through kernels/ops.py (True) or the
        plain reference forms (False); raises for "fused" on the CPU."""
        return backend_route(self.backend, x.is_cuda) != "plain"

    def causal_attention(self, q, k, v, E, F, *, block_size: int,
                         block_slots: int, scale: float,
                         chunked: bool = False) -> torch.Tensor:
        """Full-sequence blockwise-causal attention (prefill and training),
        differentiable on both routes.
        q (B, S, H, Dh); k/v (B, S, Hkv, Dh); E/F (c, r) or (Hkv, c, r).
        `chunked` selects the memory-bounded chunked form on the plain
        route; the kernel route streams query blocks itself and ignores
        it, as the JAX package's fused route does."""
        if not self.uses_kernels(q):
            fn = (causal_lib.blockwise_causal_attention_chunked if chunked
                  else causal_lib.blockwise_causal_attention)
            return fn(q, k, v, E, F, block_size=block_size, scale=scale)
        return kernel_ops.fused_blockwise_causal_attention(
            q, k, v, E, F, block_size=block_size, block_slots=block_slots,
            scale=scale, backward_impl=self.backward_impl)

    def exact_attention(self, q, k, v, E, F, *, projection: str,
                        scale: float) -> torch.Tensor:
        """Exact (bidirectional) Linformer attention: sequence projection of
        K/V, then attention over the K compressed slots; differentiable on
        both routes. q (B, S, H, Dh); k/v (B, S, Hkv, Dh); E/F per
        `projection`: linear (max_seq, K) or (Hkv, max_seq, K), conv/pool
        (c, r). On the kernel route a linear, shared 2-D E goes through
        kernel 6 as E[:S] for k and F[:S] for v, then kernel 5; per-head,
        conv and pool projections run core/linformer.project_kv in plain
        torch, then kernel 5 (the JAX package's rule). A sequence longer
        than a linear E's rows raises a ValueError on both routes."""
        if not self.uses_kernels(q):
            return lin_lib.exact_linformer_attention(q, k, v, E, F,
                                                     kind=projection,
                                                     scale=scale)
        if projection == "linear" and E.ndim == 2:
            S = q.shape[1]
            lin_lib.check_projection_rows(S, E)
            lin_lib.check_projection_rows(S, F)
            kbar = kernel_ops.fused_seq_projection(k, E[:S])
            vbar = kernel_ops.fused_seq_projection(v, F[:S])
        else:
            kbar, vbar = lin_lib.project_kv(k, v, E, F, kind=projection)
        return kernel_ops.fused_linformer_attention(q, kbar, vbar,
                                                    scale=scale)

    def chunk_prefill_attention(self, q, k, v, comp_k, comp_v, start_blocks,
                                *, block_size: int, block_slots: int,
                                scale: float) -> torch.Tensor:
        """Prefix-form attention for a prefill chunk at per-row offsets
        against the slot-resident compressed cache, differentiable on both
        routes (the kernel route's backward follows `backward_impl`).
        q (B, P, H, Dh); comp_* (B, M, Hkv, Dh) full slot buffers;
        start_blocks (B,) int."""
        if not self.uses_kernels(q):
            return causal_lib.blockwise_causal_prefix_attention(
                q, k, v, comp_k, comp_v, start_blocks,
                block_size=block_size, block_slots=block_slots, scale=scale)
        return kernel_ops.fused_chunk_prefill_attention(
            q, k, v, comp_k, comp_v, start_blocks, block_size=block_size,
            block_slots=block_slots, scale=scale,
            backward_impl=self.backward_impl)

    def decode_attention(self, q_t, raw_k, raw_v, comp_k, comp_v, loc_ok,
                         glob_ok, *, scale: float) -> torch.Tensor:
        """Single-token decode attention over [raw ring | compressed slots]
        with per-row validity masks. q_t (B, 1, H, Dh); raw_* (B, c, Hkv,
        Dh); comp_* (B, M, Hkv, Dh); loc_ok (B, c) / glob_ok (B, M) bool."""
        if not self.uses_kernels(q_t):
            return causal_lib.masked_decode_attention(
                q_t, raw_k, raw_v, comp_k, comp_v, loc_ok, glob_ok,
                scale=scale)
        bias_loc, bias_glob = decode_biases(loc_ok, glob_ok)
        return kernel_ops.fused_decode_attention(
            q_t, raw_k, raw_v, comp_k, comp_v, bias_loc, bias_glob,
            scale=scale)


    # -- the paged, quantized cache -----------------------------------------

    def decode_attention_q(self, q_t, raw_k, raw_v, raw_k_s, raw_v_s,
                           comp_k, comp_v, comp_k_s, comp_v_s, loc_ok,
                           glob_ok, *, scale: float) -> torch.Tensor:
        """Quantized-cache decode: the ring and the page-gathered slots
        arrive as int8/fp8 codes with fp32 scales, raw_*_s (B, c, Hkv) per
        token and comp_*_s (B, M, Hkv) per slot. The kernel route
        dequantises inside the kernel; the reference route dequantises in
        plain torch and runs the dense reference."""
        if not self.uses_kernels(q_t):
            return causal_lib.masked_decode_attention(
                q_t, dequantize_blockwise(raw_k, raw_k_s), dequantize_blockwise(raw_v, raw_v_s),
                dequantize_blockwise(comp_k, comp_k_s), dequantize_blockwise(comp_v, comp_v_s), loc_ok,
                glob_ok, scale=scale)
        bias_loc, bias_glob = decode_biases(loc_ok, glob_ok)
        return kernel_ops.fused_decode_attention_q(
            q_t, raw_k, raw_v, raw_k_s, raw_v_s, comp_k, comp_v, comp_k_s,
            comp_v_s, bias_loc, bias_glob, scale=scale)

    def chunk_prefill_attention_q(self, q, k, v, comp_k, comp_v, comp_k_s,
                                  comp_v_s, start_blocks, *,
                                  block_size: int, block_slots: int,
                                  scale: float) -> torch.Tensor:
        """Quantized-cache chunk prefill: the page-gathered slot buffer as
        int8/fp8 codes with per-slot scales comp_*_s (B, M, Hkv); the
        chunk's own k/v are full-precision activations."""
        if not self.uses_kernels(q):
            return causal_lib.blockwise_causal_prefix_attention(
                q, k, v, dequantize_blockwise(comp_k, comp_k_s), dequantize_blockwise(comp_v, comp_v_s),
                start_blocks, block_size=block_size,
                block_slots=block_slots, scale=scale)
        return kernel_ops.fused_chunk_prefill_attention_q(
            q, k, v, comp_k, comp_v, comp_k_s, comp_v_s, start_blocks,
            block_size=block_size, block_slots=block_slots, scale=scale)


def resolve_attention_plan(acfg: AttentionConfig) -> AttentionPlan:
    """The plan of one attention config."""
    return AttentionPlan(backend=acfg.backend,
                         backward_impl=acfg.backward_impl)


def as_plan(plan: Union[AttentionPlan, str, None]) -> AttentionPlan:
    """Normalize a plan-or-backend-string; None means the reference plan
    (as in the JAX package)."""
    if isinstance(plan, AttentionPlan):
        return plan
    return AttentionPlan(backend=plan or "reference")



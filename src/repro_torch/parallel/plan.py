"""Mesh-aware attention execution plan.

Counterpart of ``repro/parallel/plan.py``: ONE place decides how attention
executes, so call sites (models/attention.py, core/cache.py, the serving
engine) never branch on backend strings or on the mesh. The knob is the
JAX package's ``AttentionConfig.backend``:

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

Under a mesh (``resolve_attention_plan(acfg, ctx)``, cached per (config,
ctx)) the plan also picks the dims the kernels shard over:

* head parallelism (tp): ``ctx.model_axis`` when wider than 1; the KV-head
  axis shards (launch/mesh.validate_attention_mesh warns and drops tp
  unless tp divides Hkv), per-head E/F shard with their heads, a shared
  E/F is read whole by every shard;
* sequence parallelism (sp): ``ctx.seq_axis`` when wider than 1; each
  shard keeps its causal blocks resident and all-gathers the compressed
  k̄/v̄ prefix (core/seq_parallel.py holds the shard-local bodies);
* batch: the data-like dims shard the batch inside the same region when
  they divide B (otherwise the batch rides replicated).

Per form: the training forms (``causal_attention``, ``exact_attention``
for a shared linear E) take tp × sp × data; chunk prefill takes tp, plus
sp when the chunk divides (its start blocks shift by the shard's block
offset); decode takes tp only.

The plan takes and returns whole tensors, but for a plan held to this
rank's heads (below). A manual region (``manual``: a
mesh with tp or sp wider than 1 and a backend other than "reference")
takes this rank's shard of the head, sequence and batch axes through
parallel/comm.py's autograd collectives, runs the same kernels/ops.py
wrappers on it (mesh-blind, at local shapes; the plain twins on the CPU),
and gathers the output back whole. "reference" under a mesh runs the
plain forms on the whole tensors with no region: the JAX package's GSPMD
route computes the same numbers.

Tensor parallelism (the training layout, models/attention.py): the
projections give this rank's heads, and the model entry points hold the
plan to them (``held(tp)``, ``heads_held``). Every form then takes q, k
and v as this rank's heads (``Held`` in the region specs: neither split
nor copied over tp) and returns this rank's heads, with no all-gather of
the output; the plain route runs its forms on those heads, a per-head
E/F cut to them, and its pool is laid out over tp too.

The engine's pool on a tp mesh is laid out per ``cache_pspecs`` (JAX's
rule: the KV-head axis over tp, scale leaves on their last axis, the rest
whole): ``place_cache`` keeps this rank's heads of each leaf, and the
cache writers (core/cache.py, models/attention.py) write this rank's
heads of k and v into such a pool (``head_shard``). That is the only
layout the decode and chunk-prefill regions take under tp: their k, v and
pool operands arrive as this rank's heads (``Held`` in their specs), and
the region neither splits nor copies them again. Rows stay whole on every
rank, as ``cache_pspecs`` replicates them. A "reference" plan opens no
region, so it keeps its pool whole.

The batch layout of the training step is here too (``data_batch_pspec``,
``local_batch``: a rank's rows, through parallel/sharding.shard_activation).
On a ("pod", "data", "model") mesh the rows of the data dims are pod-major,
so a rank's rows are its pod's slice of the global batch, then its own:
JAX's reshape to (n_pods, per-pod batch) and its pod specs, as one
selection.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.core import causal as causal_lib
from repro_torch.core import linformer as lin_lib
from repro_torch.core import seq_parallel as sp_lib
from repro_torch.core.cache import dequantize_blockwise
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.common import backend_route, backward_route
from repro_torch.launch.mesh import (validate_attention_mesh,
                                     validate_seq_shards)
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (Axis, ParallelCtx,
                                          shard_activation)


@dataclasses.dataclass(frozen=True)
class Held:
    """A region spec entry for a dim that arrives already split over
    `axes` (a pool laid out per cache_pspecs): neither split nor copied
    over them again."""
    axes: Tuple[Axis, ...]


# A region spec: one entry per tensor dim, the mesh dims (Axis records)
# that split it, over their product with the first major, or Held; ()
# keeps the dim whole.
Spec = Tuple[Union[Tuple[Axis, ...], Held], ...]


def _spec_axes(entry) -> Tuple[Axis, ...]:
    return entry.axes if isinstance(entry, Held) else entry


def decode_biases(loc_ok: torch.Tensor, glob_ok: torch.Tensor):
    """Boolean validity masks -> the decode kernel's additive fp32 biases
    (0 attendable, NEG_INF masked)."""
    zero = torch.zeros((), dtype=torch.float32, device=loc_ok.device)
    neg = torch.full((), causal_lib.NEG_INF, dtype=torch.float32,
                     device=loc_ok.device)
    return torch.where(loc_ok, zero, neg), torch.where(glob_ok, zero, neg)


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """Execution plan for the attention forms of one config on one mesh.
    Frozen and hashable: resolved once per (config, ctx). The mesh dims
    are the ctx's Axis records (parallel/sharding.py), process groups
    included."""

    backend: str = "auto"            # AttentionConfig.backend knob
    backward_impl: str = "fused"     # AttentionConfig.backward_impl knob
    tp_dim: Optional[Axis] = None    # mesh dim sharding the (KV-)head axis
    sp_dim: Optional[Axis] = None    # mesh dim sharding the sequence axis
    data_dims: Tuple[Axis, ...] = ()  # batch dims inside the region
    # q, k, v arrive as this rank's heads over tp_dim, and leave so
    heads_held: bool = False

    def __post_init__(self):
        backend_route(self.backend, True)     # raise on an unknown knob
        backward_route(self.backward_impl)

    def uses_kernels(self, x: torch.Tensor) -> bool:
        """Whether a call on `x` goes through kernels/ops.py (True) or the
        plain reference forms (False); raises for "fused" on the CPU."""
        return backend_route(self.backend, x.is_cuda) != "plain"

    # -- mesh widths and the region's specs ----------------------------------

    @property
    def tp_axis(self) -> Optional[str]:
        return None if self.tp_dim is None else self.tp_dim.name

    @property
    def sp_axis(self) -> Optional[str]:
        return None if self.sp_dim is None else self.sp_dim.name

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.data_dims)

    @property
    def tp(self) -> int:
        return comm.flat_width((self.tp_dim,))

    @property
    def sp(self) -> int:
        return comm.flat_width((self.sp_dim,))

    @property
    def manual(self) -> bool:
        """Whether the kernels run per shard inside a manual region: tp or
        sp wider than 1, and a backend other than "reference"."""
        return (self.tp > 1 or self.sp > 1) and \
            backend_route(self.backend, True) != "plain"

    def _batch_axes(self, B: int) -> Tuple[Axis, ...]:
        """The data dims shard the batch inside the region only when they
        divide it; otherwise () and the batch rides replicated (attention
        is per row, so either is correct)."""
        size = comm.flat_width(self.data_dims)
        return self.data_dims if size > 1 and B % size == 0 else ()

    def _sp_for(self, S: int, block_size: int, *, required: bool
                ) -> Tuple[Axis, ...]:
        """The sequence dim for an S-token form, or () when sp is off.
        `required=True` (training) fails fast on indivisible shapes;
        `required=False` (chunk prefill) falls back to tp only."""
        if self.sp <= 1:
            return ()
        if S % (self.sp * block_size) != 0:
            if required:
                validate_seq_shards(S, block_size, self.sp, self.sp_axis)
            return ()
        return (self.sp_dim,)

    def _heads(self) -> Tuple[Axis, ...]:
        return (self.tp_dim,) if self.tp > 1 else ()

    def held(self, tp: Optional[Axis]) -> "AttentionPlan":
        """This plan with q, k and v held to this rank's heads over `tp`
        (tensor parallelism); itself without one."""
        if tp is None or tp.width == 1:
            return self
        return dataclasses.replace(self, tp_dim=tp, heads_held=True)

    def _q_heads(self):
        """The head dim of a query operand (and of the output): this
        rank's heads already on a held plan, else split over tp."""
        return Held(self._heads()) if self.heads_held else self._heads()

    def _plain_ef(self, E: torch.Tensor) -> torch.Tensor:
        """E/F on a held plan's plain route: a per-head one cut to this
        rank's heads (its gradient gathered over tp), a shared one read by
        every rank's heads (its gradient summed over tp); else as is."""
        if not self.heads_held:
            return E
        if E.ndim == 3:
            return comm.split(E, 0, self._heads())
        return comm.copy(E, self._heads())

    def _pool_heads(self) -> Held:
        """The head dim of a cache operand of the decode and chunk-prefill
        regions: this rank's heads already (see shards_cache)."""
        return Held(self._heads())

    @property
    def shards_cache(self) -> bool:
        """Whether place_cache lays a pool out over tp: a manual or held
        plan with tp wider than 1."""
        return (self.manual or self.heads_held) and self.tp > 1

    def kv_shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's heads of an activation k or v along `dim`: as it is
        on a held plan, else head_shard."""
        return x if self.heads_held else self.head_shard(x, dim)

    def head_shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's heads of `x` along `dim` over tp (a view): what a
        cache writer stores into a pool laid out per cache_pspecs."""
        if not self.shards_cache:
            return x
        n = x.shape[dim] // self.tp
        return x.narrow(dim, self.tp_dim.coord * n, n)

    def head_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole head axis of a leaf laid out per cache_pspecs (no
        gradient): the inverse of head_shard."""
        if not self.shards_cache:
            return x
        return comm.gather(x.contiguous(), dim, self._heads())

    def _ef_spec(self, E: torch.Tensor) -> Spec:
        """Per-head E/F (Hkv, c, r) shard with their heads; a shared (c, r)
        projection is read whole by every shard."""
        if E.ndim == 3:
            return (self._heads(), (), ())
        return ((), ())

    def _chunk_specs(self, q, block_size: int):
        """The chunk-prefill region of both forms: the specs of the query
        chunk (batch, sequence when sp divides it, heads), of its k/v (this
        rank's heads), of the whole slot buffer a shard and of its per-slot
        scales, and the block offset of this rank's sequence shard."""
        B, Pq = q.shape[:2]
        sp = self._sp_for(Pq, block_size, required=False)
        shift = sp[0].coord * (Pq // self.sp // block_size) if sp else 0
        b, kvh = self._batch_axes(B), self._pool_heads()
        return ((b, sp, self._q_heads(), ()), (b, sp, kvh, ()),
                (b, (), kvh, ()), (b, (), kvh), shift)

    def _out_spec(self, spec: Spec) -> Spec:
        """A query spec as the output's: a held head entry is not
        gathered."""
        return tuple(() if isinstance(e, Held) else e for e in spec)

    @staticmethod
    def _smap(body, in_specs, out_spec):
        """The manual region: each input is split per its spec (and its
        gradient summed over the region's other dims, comm.copy), `body`
        runs on the local shards, and its output is gathered per
        `out_spec`. The region's dims are those some input splits over (or
        holds split: a Held entry)."""
        active = []
        for spec in in_specs:
            for entry in spec:
                active += [a for a in _spec_axes(entry) if a not in active]

        def run(*args):
            local = []
            for x, spec in zip(args, in_specs):
                for dim, entry in enumerate(spec):
                    if not isinstance(entry, Held):
                        x = comm.split(x, dim, entry)
                used = [a for entry in spec for a in _spec_axes(entry)]
                local.append(comm.copy(x, [a for a in active
                                           if a not in used]))
            out = body(*local)
            for dim, axes in reversed(list(enumerate(out_spec))):
                out = comm.gather(out, dim, axes)
            return out

        return run

    # -- train fwd/bwd: blockwise-causal (linformer_causal) -------------------

    def causal_attention(self, q, k, v, E, F, *, block_size: int,
                         block_slots: int, scale: float,
                         chunked: bool = False) -> torch.Tensor:
        """Full-sequence blockwise-causal attention (prefill and training),
        differentiable on both routes and under every sharding.
        q (B, S, H, Dh); k/v (B, S, Hkv, Dh); E/F (c, r) or (Hkv, c, r).
        `chunked` selects the memory-bounded chunked form on the plain
        route; the kernel route streams query blocks itself and ignores
        it, as the JAX package's fused route does. Under sp each shard runs
        the prefix form at its block offset (kernels 4r and 2's offset
        form on the card)."""
        if not self.uses_kernels(q):
            fn = (causal_lib.blockwise_causal_attention_chunked if chunked
                  else causal_lib.blockwise_causal_attention)
            return fn(q, k, v, self._plain_ef(E), self._plain_ef(F),
                      block_size=block_size, scale=scale)
        if not self.manual:
            return kernel_ops.fused_blockwise_causal_attention(
                q, k, v, E, F, block_size=block_size,
                block_slots=block_slots, scale=scale,
                backward_impl=self.backward_impl)
        B, S = q.shape[:2]
        sp = self._sp_for(S, block_size, required=True)
        qkv = (self._batch_axes(B), sp, self._q_heads(), ())
        espec = self._ef_spec(E)
        bi = self.backward_impl

        def body(q_l, k_l, v_l, E_l, F_l):
            if not sp:
                return kernel_ops.fused_blockwise_causal_attention(
                    q_l, k_l, v_l, E_l, F_l, block_size=block_size,
                    block_slots=block_slots, scale=scale, backward_impl=bi)
            return sp_lib.sp_blockwise_causal_attention(
                q_l, k_l, v_l, E_l, F_l, seq_axis=sp[0],
                block_size=block_size, block_slots=block_slots, scale=scale,
                backward_impl=bi)

        return self._smap(body, (qkv,) * 3 + (espec, espec),
                          self._out_spec(qkv))(q, k, v, E, F)

    # -- train fwd/bwd: exact bidirectional (linformer) -----------------------

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
        than a linear E's rows raises a ValueError on both routes. Under a
        mesh the region covers the shared linear E only: heads over tp,
        rows (and E's rows) over sp when sp divides S, then a psum of
        k̄/v̄ over sp; the other projections run unsharded."""
        if not self.uses_kernels(q):
            return lin_lib.exact_linformer_attention(
                q, k, v, self._plain_ef(E), self._plain_ef(F),
                kind=projection, scale=scale)
        S = q.shape[1]
        linear_shared = projection == "linear" and E.ndim == 2
        if linear_shared:
            lin_lib.check_projection_rows(S, E)
            lin_lib.check_projection_rows(S, F)
            E, F = E[:S], F[:S]
        if not self.manual or not linear_shared:
            if linear_shared:
                kbar = kernel_ops.fused_seq_projection(k, E)
                vbar = kernel_ops.fused_seq_projection(v, F)
            else:
                kbar, vbar = lin_lib.project_kv(k, v, self._plain_ef(E),
                                                self._plain_ef(F),
                                                kind=projection)
            return kernel_ops.fused_linformer_attention(q, kbar, vbar,
                                                        scale=scale)
        sp = (self.sp_dim,) if self.sp > 1 and S % self.sp == 0 else ()
        qkv = (self._batch_axes(q.shape[0]), sp, self._q_heads(), ())
        espec = (sp, ())

        def body(q_l, k_l, v_l, E_l, F_l):
            if not sp:
                kbar = kernel_ops.fused_seq_projection(k_l, E_l)
                vbar = kernel_ops.fused_seq_projection(v_l, F_l)
                return kernel_ops.fused_linformer_attention(q_l, kbar, vbar,
                                                            scale=scale)
            return sp_lib.sp_exact_linformer_attention(
                q_l, k_l, v_l, E_l, F_l, seq_axis=sp[0], scale=scale,
                fused=True)

        return self._smap(body, (qkv,) * 3 + (espec, espec),
                          self._out_spec(qkv))(q, k, v, E, F)

    # -- chunk prefill ----------------------------------------------------------

    def chunk_prefill_attention(self, q, k, v, comp_k, comp_v, start_blocks,
                                *, block_size: int, block_slots: int,
                                scale: float) -> torch.Tensor:
        """Prefix-form attention for a prefill chunk at per-row offsets
        against the slot-resident compressed cache, differentiable on both
        routes (the kernel route's backward follows `backward_impl`).
        q (B, P, H, Dh); comp_* (B, M, Hkv, Dh) full slot buffers;
        start_blocks (B,) int. Under sp, shard d of the chunk starts
        d·(P/sp)/c blocks further in. Under tp, k, v and the slots are this
        rank's heads (see the module docstring)."""
        if not self.uses_kernels(q):
            return causal_lib.blockwise_causal_prefix_attention(
                q, k, v, comp_k, comp_v, start_blocks,
                block_size=block_size, block_slots=block_slots, scale=scale)
        if not self.manual:
            return kernel_ops.fused_chunk_prefill_attention(
                q, k, v, comp_k, comp_v, start_blocks, block_size=block_size,
                block_slots=block_slots, scale=scale,
                backward_impl=self.backward_impl)
        qs, kvs, comp, _, shift = self._chunk_specs(q, block_size)
        start_blocks = kernel_ops._start_blocks(start_blocks, q)

        def body(q_l, k_l, v_l, ck_l, cv_l, sb_l):
            return kernel_ops.fused_chunk_prefill_attention(
                q_l, k_l, v_l, ck_l, cv_l, sb_l + shift,
                block_size=block_size, block_slots=block_slots, scale=scale,
                backward_impl=self.backward_impl)

        return self._smap(body, (qs, kvs, kvs, comp, comp, qs[:1]),
                          self._out_spec(qs))(
            q, k, v, comp_k, comp_v, start_blocks)

    # -- decode -------------------------------------------------------------------

    def decode_attention(self, q_t, raw_k, raw_v, comp_k, comp_v, loc_ok,
                         glob_ok, *, scale: float) -> torch.Tensor:
        """Single-token decode attention over [raw ring | compressed slots]
        with per-row validity masks. q_t (B, 1, H, Dh); raw_* (B, c, Hkv,
        Dh); comp_* (B, M, Hkv, Dh); loc_ok (B, c) / glob_ok (B, M) bool.
        Under a mesh only tp shards it (a single token has no sequence),
        and the ring and slots are this rank's heads."""
        if not self.uses_kernels(q_t):
            return causal_lib.masked_decode_attention(
                q_t, raw_k, raw_v, comp_k, comp_v, loc_ok, glob_ok,
                scale=scale)
        bias_loc, bias_glob = decode_biases(loc_ok, glob_ok)
        if not self.manual or self.tp <= 1:
            return kernel_ops.fused_decode_attention(
                q_t, raw_k, raw_v, comp_k, comp_v, bias_loc, bias_glob,
                scale=scale)
        b = self._batch_axes(q_t.shape[0])
        qs = (b, (), self._q_heads(), ())
        kv = (b, (), self._pool_heads(), ())

        def body(*xs):
            return kernel_ops.fused_decode_attention(*xs, scale=scale)

        return self._smap(body, (qs,) + (kv,) * 4 + ((b, ()),) * 2,
                          self._out_spec(qs))(
            q_t, raw_k, raw_v, comp_k, comp_v, bias_loc, bias_glob)

    # -- the paged, quantized cache -------------------------------------------

    def decode_attention_q(self, q_t, raw_k, raw_v, raw_k_s, raw_v_s,
                           comp_k, comp_v, comp_k_s, comp_v_s, loc_ok,
                           glob_ok, *, scale: float) -> torch.Tensor:
        """Quantized-cache decode: the ring and the page-gathered slots
        arrive as int8/fp8 codes with fp32 scales, raw_*_s (B, c, Hkv) per
        token and comp_*_s (B, M, Hkv) per slot. The kernel route
        dequantises inside the kernel; the reference route dequantises in
        plain torch and runs the dense reference. Sharded as the dense
        decode, the scales with their heads."""
        if not self.uses_kernels(q_t):
            return causal_lib.masked_decode_attention(
                q_t, dequantize_blockwise(raw_k, raw_k_s),
                dequantize_blockwise(raw_v, raw_v_s),
                dequantize_blockwise(comp_k, comp_k_s),
                dequantize_blockwise(comp_v, comp_v_s), loc_ok, glob_ok,
                scale=scale)
        bias_loc, bias_glob = decode_biases(loc_ok, glob_ok)
        args = (q_t, raw_k, raw_v, raw_k_s, raw_v_s, comp_k, comp_v,
                comp_k_s, comp_v_s, bias_loc, bias_glob)
        if not self.manual or self.tp <= 1:
            return kernel_ops.fused_decode_attention_q(*args, scale=scale)
        b, kvh = self._batch_axes(q_t.shape[0]), self._pool_heads()
        qs = (b, (), self._q_heads(), ())
        kv, sc = (b, (), kvh, ()), (b, (), kvh)

        def body(*xs):
            return kernel_ops.fused_decode_attention_q(*xs, scale=scale)

        return self._smap(body, (qs, kv, kv, sc, sc, kv, kv, sc, sc)
                          + ((b, ()),) * 2, self._out_spec(qs))(*args)

    def chunk_prefill_attention_q(self, q, k, v, comp_k, comp_v, comp_k_s,
                                  comp_v_s, start_blocks, *,
                                  block_size: int, block_slots: int,
                                  scale: float) -> torch.Tensor:
        """Quantized-cache chunk prefill: the page-gathered slot buffer as
        int8/fp8 codes with per-slot scales comp_*_s (B, M, Hkv); the
        chunk's own k/v are full-precision activations. Sharded as the
        dense chunk prefill."""
        if not self.uses_kernels(q):
            return causal_lib.blockwise_causal_prefix_attention(
                q, k, v, dequantize_blockwise(comp_k, comp_k_s),
                dequantize_blockwise(comp_v, comp_v_s), start_blocks,
                block_size=block_size, block_slots=block_slots, scale=scale)
        kw = dict(block_size=block_size, block_slots=block_slots,
                  scale=scale)
        if not self.manual:
            return kernel_ops.fused_chunk_prefill_attention_q(
                q, k, v, comp_k, comp_v, comp_k_s, comp_v_s, start_blocks,
                **kw)
        qs, kvs, comp, sc, shift = self._chunk_specs(q, block_size)
        start_blocks = kernel_ops._start_blocks(start_blocks, q)

        def body(q_l, k_l, v_l, ck_l, cv_l, cks_l, cvs_l, sb_l):
            return kernel_ops.fused_chunk_prefill_attention_q(
                q_l, k_l, v_l, ck_l, cv_l, cks_l, cvs_l, sb_l + shift, **kw)

        return self._smap(body, (qs, kvs, kvs, comp, comp, sc, sc, qs[:1]),
                          self._out_spec(qs))(
            q, k, v, comp_k, comp_v, comp_k_s, comp_v_s, start_blocks)

    # -- cache placement ------------------------------------------------------

    def cache_pspecs(self, cache: Dict) -> Dict[str, tuple]:
        """The spec of each decode-cache leaf (JAX's rule): the KV-head
        axis over tp at nd-2, scale leaves (``*_s``, head axis last) on
        their last axis, ``lengths``, ``page_table`` and leaves of rank < 2
        whole. Names stand for the mesh dims; a plan that does not shard
        its pool (see shards_cache) gives every leaf whole."""
        tp = self.tp_axis if self.shards_cache else None
        specs = {}
        for name, leaf in cache.items():
            nd = len(leaf.shape)
            parts = [None] * nd
            if name in ("lengths", "page_table") or nd < 2:
                pass
            elif name.endswith("_s"):
                parts[nd - 1] = tp
            else:
                parts[nd - 2] = tp
            specs[name] = tuple(parts)
        return specs

    def place_cache(self, cache: Dict) -> Dict:
        """A cache laid out per cache_pspecs: each leaf's local heads, as
        tensors of their own (no-op when the plan does not shard its
        pool)."""
        if not self.shards_cache:
            return cache
        out = {}
        for name, spec in self.cache_pspecs(cache).items():
            x = cache[name]
            if self.tp_axis in spec:
                x = self.head_shard(x, spec.index(self.tp_axis)).clone()
            out[name] = x
        return out

    def gather_cache(self, cache: Dict) -> Dict:
        """The whole leaves of a cache laid out per cache_pspecs (the
        inverse of place_cache; every rank calls it)."""
        if not self.shards_cache:
            return cache
        return {name: (self.head_gather(cache[name],
                                        spec.index(self.tp_axis))
                       if self.tp_axis in spec else cache[name])
                for name, spec in self.cache_pspecs(cache).items()}


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------


# Bounded: a ctx holds its mesh's process groups (and compares by them, so
# a mesh rebuilt on new groups resolves anew); the plans of meshes no
# longer in use fall out instead of keeping their groups alive.
@functools.lru_cache(maxsize=64)
def _resolve_cached(acfg: AttentionConfig,
                    ctx: Optional[ParallelCtx]) -> AttentionPlan:
    knobs = dict(backend=acfg.backend, backward_impl=acfg.backward_impl)
    if ctx is None or ctx.mesh is None:
        return AttentionPlan(**knobs)
    tp, sp = (ctx.axis(ctx.model_axis) if ctx.model_shards > 1 else None,
              ctx.axis(ctx.seq_axis) if ctx.seq_shards > 1 else None)
    if tp is not None and backend_route(acfg.backend, True) != "plain":
        # the model dim is shared (tensor and expert parallelism): a width
        # that cannot shard Hkv warns and drops the head sharding
        if not validate_attention_mesh(
                ctx.mesh, num_heads=acfg.num_heads,
                num_kv_heads=acfg.num_kv_heads, model_axis=ctx.model_axis):
            tp = None
    return AttentionPlan(**knobs, tp_dim=tp, sp_dim=sp,
                         data_dims=tuple(ctx.axis(a) for a in ctx.data_axes))


def resolve_attention_plan(acfg: AttentionConfig,
                           ctx: Optional[ParallelCtx] = None
                           ) -> AttentionPlan:
    """The plan of one attention config on one parallel context, cached
    per (config, ctx): equal ctxs share their mesh's process groups."""
    return _resolve_cached(acfg, ctx)


def as_plan(plan: Union[AttentionPlan, str, None]) -> AttentionPlan:
    """Normalize a plan-or-backend-string; None means the reference plan
    (as in the JAX package)."""
    if isinstance(plan, AttentionPlan):
        return plan
    return AttentionPlan(backend=plan or "reference")


# ---------------------------------------------------------------------------
# Batch layout: specs for parallel/sharding.shard_activation
# ---------------------------------------------------------------------------


def data_batch_pspec(ctx: ParallelCtx, ndim: int) -> tuple:
    """Batch tensors shard their leading dim over the data-like dims."""
    return (ctx.data_axes if ctx.data_axes else None,) + (None,) * (ndim - 1)


def local_batch(batch: Dict, ctx: Optional[ParallelCtx]) -> Dict:
    """This rank's rows of every leaf of a global batch, per
    data_batch_pspec (the whole batch without a mesh)."""
    if ctx is None or ctx.mesh is None:
        return batch
    return {k: shard_activation(v, ctx, data_batch_pspec(ctx, v.ndim))
            for k, v in batch.items()}

"""Sequence-parallel Linformer attention, and its communication-cost model.

Counterpart of ``repro/core/seq_parallel.py``. The paper's compression
K̄ = EᵀK is a linear reduction over the sequence axis, so sharding the
sequence costs only a collective over the (k × d) compressed operands,
independent of n; standard attention under sequence parallelism
ring-exchanges O(n·d) of K/V. The two shard-local bodies run inside the
manual region that ``parallel/plan.py`` opens (the plan owns the splits
and gathers at the region's edge; these own the per-shard math and the
collective inside):

* :func:`sp_exact_linformer_attention`, the exact (bidirectional) form:
  each rank projects its sequence shard with its E/F row block, sums the
  compressed K̄/V̄ over the sequence axis (``comm.psum``), then attends its
  local queries. One psum of 2·(B, K, Hkv, Dh).
* :func:`sp_blockwise_causal_attention`, the causal (blockwise) form: each
  rank compresses its local blocks into r slots each, all-gathers the
  compressed prefix (``comm.all_gather_tiled``: 2·(B, (S/c)·r, Hkv, Dh);
  the raw blocks stay resident), and attends its local query blocks
  through the prefix form at this rank's absolute block offset. On the
  kernel route that is kernel 4r forward and kernel 2's offset form
  backward (kernels/ops.fused_chunk_prefill_attention); the all-gather's
  backward sums every rank's full-buffer dk̄/dv̄ and takes this rank's
  slice, which the local ``compress_blocks`` VJP turns into dk/dv/dE/dF.

:func:`seq_parallel_linformer_attention` is the self-contained exact form
over whole tensors, the sequence sharded over one mesh dim (the model dim
by default), as the JAX function.

The comm-byte functions are plain arithmetic, read by the telemetry's cost
attribution (telemetry/cost.py) and held to ``parallel/comm.BYTES`` by the
tests.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import causal as causal_lib
from repro_torch.core import linformer as lin_lib
from repro_torch.kernels import ops as kernel_ops
from repro_torch.parallel import comm


def sp_exact_linformer_attention(q_l, k_l, v_l, E_l, F_l, *, seq_axis,
                                 scale: float, fused: bool) -> torch.Tensor:
    """Exact-form shard-local body. q_l (B, S/sp, H_l, Dh); k_l/v_l
    (B, S/sp, Hkv_l, Dh); E_l/F_l (S/sp, K), this shard's row block;
    `seq_axis` the sharded mesh dim (an Axis). `fused` projects with
    kernel 6 and attends with kernel 5 (kernels/ops.py), else plain
    torch. Output stays sequence-sharded."""
    if fused:
        kbar = kernel_ops.fused_seq_projection(k_l, E_l)
        vbar = kernel_ops.fused_seq_projection(v_l, F_l)
    else:
        kbar = torch.einsum("bshd,sk->bkhd", k_l, E_l.to(k_l.dtype))
        vbar = torch.einsum("bshd,sk->bkhd", v_l, F_l.to(v_l.dtype))
    kbar = comm.psum(kbar, (seq_axis,))        # (B, K, Hkv, Dh): tiny
    vbar = comm.psum(vbar, (seq_axis,))
    if fused:
        return kernel_ops.fused_linformer_attention(q_l, kbar, vbar,
                                                    scale=scale)
    return lin_lib.attend_compressed(q_l, kbar, vbar, scale=scale)


def sp_blockwise_causal_attention(q_l, k_l, v_l, E_l, F_l, *, seq_axis,
                                  block_size: int, block_slots: int,
                                  scale: float, backward_impl: str = "fused"
                                  ) -> torch.Tensor:
    """Blockwise-causal shard-local body: compress the local blocks,
    all-gather the compressed prefix, attend the local queries at this
    shard's block offset through kernels/ops.fused_chunk_prefill_attention
    (the plain twins for CPU tensors).

    The sequence is sharded contiguously with the local length a multiple
    of `block_size`: shard d holds absolute blocks [d·nb_l, (d+1)·nb_l),
    and the tiled all-gather concatenates shards in axis order, so
    gathered slot m belongs to absolute block m // r, the visibility rule
    the prefix form's cut applies at start block d·nb_l."""
    B, S_l, Hkv, Dh = k_l.shape
    c, r = block_size, block_slots
    if S_l % c != 0:
        raise ValueError(
            f"sequence-parallel shard length {S_l} is not a multiple of the "
            f"attention block size {c}")
    nb_l = S_l // c
    kbar_l = causal_lib.compress_blocks(
        k_l.reshape(B, nb_l, c, Hkv, Dh), E_l).reshape(B, nb_l * r, Hkv, Dh)
    vbar_l = causal_lib.compress_blocks(
        v_l.reshape(B, nb_l, c, Hkv, Dh), F_l).reshape(B, nb_l * r, Hkv, Dh)
    kbar = comm.all_gather_tiled(kbar_l, 1, seq_axis)
    vbar = comm.all_gather_tiled(vbar_l, 1, seq_axis)
    start_blocks = torch.full((B,), seq_axis.coord * nb_l,
                              dtype=torch.int32, device=q_l.device)
    return kernel_ops.fused_chunk_prefill_attention(
        q_l, k_l, v_l, kbar, vbar, start_blocks, block_size=c,
        block_slots=r, scale=scale, backward_impl=backward_impl)


def seq_parallel_linformer_attention(q, k, v, E, F, ctx, *,
                                     seq_axis: Optional[str] = None,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """Exact Linformer attention over whole tensors with the sequence
    sharded over `seq_axis` (default: the model dim) of ``ctx.mesh``:
    q (B, S, H, Dh), k/v (B, S, Hkv, Dh), E/F (S, K) row-sharded with the
    sequence. Plain torch per shard; one psum of 2·(B, K, Hkv, Dh).
    Returns the whole (B, S, H, Dh) on every rank."""
    if ctx is None or ctx.mesh is None:
        raise ValueError("seq_parallel_linformer_attention needs a ctx "
                         "with a mesh")
    axis = ctx.axis(seq_axis or ctx.model_axis)
    if axis is None:
        raise ValueError(f"the mesh has no dim {seq_axis or ctx.model_axis!r}")
    scale_ = scale if scale is not None else q.shape[-1] ** -0.5
    q_l, k_l, v_l = (comm.split(x, 1, (axis,)) for x in (q, k, v))
    E_l, F_l = (comm.split(x, 0, (axis,)) for x in (E, F))
    out = sp_exact_linformer_attention(q_l, k_l, v_l, E_l, F_l,
                                       seq_axis=axis, scale=scale_,
                                       fused=False)
    return comm.gather(out, 1, (axis,))


# ---------------------------------------------------------------------------
# Communication-cost model
# ---------------------------------------------------------------------------


def seq_parallel_comm_bytes(n: int, k: int, d_total: int, shards: int,
                            dtype_bytes: int = 2) -> Tuple[int, int]:
    """(linformer_bytes, ring_attention_bytes) per device for one layer of
    the EXACT form: a psum of K̄/V̄ vs a ring exchange of raw K/V."""
    lin = 2 * k * d_total * dtype_bytes                   # psum of K̄,V̄
    ring = 2 * (n // shards) * d_total * (shards - 1) * dtype_bytes
    return lin, ring


def blockwise_sp_comm_bytes(n: int, block_size: int, block_slots: int,
                            d_total: int, shards: int,
                            dtype_bytes: int = 2) -> Tuple[int, int]:
    """(linformer_bytes, ring_attention_bytes) per device for one layer of
    the CAUSAL (blockwise) form under sequence parallelism: the all-gather
    moves only the compressed prefix — 2·(n/c)·r·d bytes, a c/r-fold
    reduction over ring-exchanging the raw K/V — while the local causal
    blocks never leave their shard."""
    m_total = (n // block_size) * block_slots
    lin = 2 * m_total * d_total * dtype_bytes             # all-gather of k̄,v̄
    ring = 2 * (n // shards) * d_total * (shards - 1) * dtype_bytes
    return lin, ring

"""Shared kernel-wrapper plumbing: device resolution, layout moves, the
backend table, and the fail-fast shape guards of the CUDA kernels.

Counterpart of ``repro/kernels/common.py``, plus the kernels' fake path:
a wrapper handed FakeTensors (``is_fake``: the dry run of
launch/dryrun.py) allocates its outputs as the launch would, calls no
kernel and reports the launch and the kernel's cost (``add_cost``) to the
counters of ``cost_sink`` (launch/step_cost.py), from the visible-work
counts below; its launch counters count only kernels launched. The TPU package bounded its
kernels by VMEM budgets; here the guards are derived from what the CUDA
kernels in ``csrc/`` accept: the head dims they are instantiated for, whole
blocks (``S % c == 0``), ``M == nb·r`` compressed slots (any M for the
prefix form), the storage dtypes and scale layouts of the quantized cache,
and the shared memory a thread block may use on the H100. The tile
constants below must match the ``.cu`` sources. The port keeps the JAX
package's own fail-fast checks as well (the exact form's ``MAX_EXACT_K``
and ``divisor_block`` grid floor at its default tiles; the causal,
chunk-prefill and decode forms' ``MAX_PINNED_SLOTS``), so it refuses the
shapes the JAX package refuses.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple
from typing import Union

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import build

# AttentionConfig.backend -> (route for CPU tensors, route for CUDA tensors).
# "kernel" goes through kernels/ops.py, whose wrappers launch the CUDA kernel
# for a CUDA tensor and run the kernel's plain twin for a CPU tensor;
# "plain" goes to the reference forms in core/causal.py.
BACKEND_ROUTES: Dict[str, Tuple[str, str]] = {
    "auto": ("kernel", "kernel"),
    "fused": ("unavailable", "kernel"),
    "reference": ("plain", "plain"),
}

# AttentionConfig.backward_impl -> route of the blockwise-causal backward on
# the "kernel" route: "kernel" is the autograd Function of kernels/ops.py
# (the residual-emitting forward, then the backward kernel); "plain" is
# autograd through the reference form of core/causal.py.
BACKWARD_ROUTES: Dict[str, str] = {
    "fused": "kernel",
    "reference": "plain",
}

# AttentionConfig.backend -> the backend name after resolution, as the JAX
# package's plan records it (its `resolve_backend` on the CPU and the TPU):
# "auto" runs the kernels, so it resolves to "fused". Read by the cost
# attribution (telemetry/cost.py), never by dispatch.
RESOLVED_BACKENDS: Dict[str, str] = {
    "auto": "fused",
    "fused": "fused",
    "reference": "reference",
}

# Shared memory one thread block may use on an H100 (227 KB); above 48 KB
# only as dynamic shared memory after cudaFuncSetAttribute.
MAX_SMEM_PER_BLOCK = 232448

# csrc/blockwise_causal_attn.cu: head dims the kernels are instantiated for,
# the SIMT kernel's key tile and the pitch of its probability tile. The
# tensor-core kernel (bf16: kernels 1, 1r, 4, 4r and 8, namespace tc of the
# source): a 64-row query tile of one or two query heads
# a block (4 warps of 16 rows each), 64-key tiles in several stages, bf16
# rows of pitch Dh + 8, and for int8/fp8 slots byte rows of pitch
# Dh + BCA_MMA_CODE_PAD beside each stage's k and v tiles.
BCA_HEAD_DIMS = (16, 32, 64, 128)
BCA_TILE_K = 64
BCA_P_PITCH = BCA_TILE_K + 16
BCA_MMA_TILE_Q = 64
BCA_MMA_TILE_K = 64
BCA_MMA_CODE_PAD = 16


def bca_prefix_mma_heads(group: int) -> int:
    """Query heads a block of the tensor-core prefix kernel takes: two of
    one kv head when the group G is even, else one."""
    return 2 if group % 2 == 0 else 1


def bca_prefix_mma_stages(heads: int) -> int:
    """Its tile buffers: three for two heads a block, two for one."""
    return 3 if heads == 2 else 2


# csrc/blockwise_causal_attn_bwd.cu, fp32 (SIMT): the dq kernel's key tile
# and the pitch of its dS tile (its query tile and the dk/dv kernel's key
# tile are bca_query_tile(c)).
BCA_BWD_TILE_K = 64
BCA_BWD_S_PITCH = BCA_BWD_TILE_K + 16

# The same source in bf16 (tensor cores, namespace tcb): 4 warps a block in
# each kernel; the dk/dv kernel owns 16 keys or slots a warp and walks the
# query rows in steps of BCA_BWD_MMA_ROW_STEP, the dq kernel owns 16 query
# rows a warp and walks 64-key tiles; both through BCA_BWD_MMA_STAGES
# cp.async buffers of bf16 rows of pitch Dh + 8. The rows of a slot tile are
# cut into splits of BCA_BWD_SPLIT_ROWS (bca_bwd_slot_rows), each a block
# that writes fp32 partials (bca_bwd_partials_shape) for a reduction pass.
BCA_BWD_MMA_WARPS = 4
BCA_BWD_MMA_TILE_K = 16 * BCA_BWD_MMA_WARPS
BCA_BWD_MMA_ROW_STEP = 32
BCA_BWD_MMA_TILE_Q = 16 * BCA_BWD_MMA_WARPS
BCA_BWD_MMA_TILE_KEY = 64
BCA_BWD_MMA_STAGES = 2
BCA_BWD_SPLIT_ROWS = 512

# csrc/decode_attn.cu (kernels 3 and 7): the 64-key tile (the unit of
# masked-tile skipping and of a key split), the query rows of a kv head's
# group one block takes (the grid's z axis covers the rest of G), the key
# rows of a tile one lane holds, and the head dims it is built for. The
# split count aims at DECODE_TARGET_BLOCKS thread blocks: two for each of
# the H100's 132 SMs.
DECODE_TILE = 64
DECODE_GROUP_ROWS = 4
DECODE_KEYS_PER_LANE = 4
DECODE_HEAD_DIMS = BCA_HEAD_DIMS
DECODE_TARGET_BLOCKS = 2 * 132
DECODE_MAX_GRID_YZ = 65535           # CUDA's grid limit on the y and z axes
DECODE_MAX_GROUP = DECODE_GROUP_ROWS * DECODE_MAX_GRID_YZ

# The JAX package's bound on the compressed slot buffer of the causal,
# chunk-prefill and decode forms (its repro/kernels/common.py): its TPU
# kernels pin all M slots in VMEM per grid step. The CUDA kernels stream
# slot tiles and need no such bound; the port keeps it so that it refuses
# what the JAX package refuses.
MAX_PINNED_SLOTS = 4096

# csrc/linformer_attn.cu (kernel 5, the exact form) and the head dims it is
# built for. fp32 (SIMT, exact_fwd_kernel): 64-row query tiles, the
# blockwise kernel's 64-slot tile and probability pitch (it shares its tile
# step), fp32 rows of pitch Dh + 1. bf16 (tensor cores, exact_fwd_mma_kernel):
# two query tiles a block of 4 warps of 16 rows, bf16 rows of pitch Dh + 8,
# slot tiles of 128 (64 at Dh = 128), one k̄/v̄ stage when K fits one tile,
# two otherwise.
EXACT_TILE_Q = 64
EXACT_HEAD_DIMS = BCA_HEAD_DIMS
EXACT_MMA_TILE_Q = 64
EXACT_MMA_Q_TILES = 2


def exact_mma_tile_kv(head_dim: int) -> int:
    return 128 if head_dim <= 64 else 64


# csrc/seq_projection.cu (kernel 6) and the head dims it is built for. fp32
# (SIMT, seq_projection_kernel): 64 slots per block, 32 sequence rows per
# shared-memory step. bf16 (tensor cores, seq_projection_mma_kernel): 8 warps
# of 16 slots, 64-row chunks of x (pitch Dh + 8) and of E (pitch slot tile
# + 8) in two cp.async stages.
SP_TILE_K = 64
SP_TILE_S = 32
SP_HEAD_DIMS = BCA_HEAD_DIMS
SP_MMA_TILE_K = 128
SP_MMA_CHUNK_S = 64
SP_MMA_STAGES = 2


# The JAX package's fail-fast bounds of the exact form (its
# repro/kernels/common.py): the compressed length the TPU kernel pins whole
# in VMEM, and the grid floor `divisor_block` enforces at the kernels'
# default tiles. The CUDA kernels stream slots and mask ragged tiles, so
# they need neither; the port keeps both so that it refuses what the JAX
# package refuses.
MAX_EXACT_K = 512
MIN_DIVISOR_BLOCK = 8
DEFAULT_BLOCK_Q = 256        # linformer_attn query tile (JAX default)
DEFAULT_BLOCK_S = 512        # seq_projection sequence tile (JAX default)
# query blocks a chunk of the chunked reference causal form (JAX default),
# the fallback of the tuning table's causal_chunked entries (tune/table.py)
DEFAULT_Q_CHUNK_BLOCKS = 8

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# storage dtypes of the paged, quantized cache (codes of csrc/common.cuh)
STORAGE_DTYPES = {torch.int8: 2, torch.float8_e4m3fn: 3}


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """The device an entry point runs on. CUDA is the default; asking for it
    on a machine without a card raises instead of silently using the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


def backend_route(backend: str, is_cuda: bool) -> str:
    """Route of one attention call: "kernel" or "plain" (see BACKEND_ROUTES)."""
    try:
        cpu_route, cuda_route = BACKEND_ROUTES[backend]
    except KeyError:
        raise ValueError(f"unknown attention backend {backend!r}; expected "
                         f"one of {sorted(BACKEND_ROUTES)}") from None
    route = cuda_route if is_cuda else cpu_route
    if route == "unavailable":
        raise ValueError(
            f"backend={backend!r} needs CUDA tensors: the CUDA kernels "
            "cannot run on the CPU (use 'auto' or 'reference')")
    return route


def backward_route(backward_impl: str) -> str:
    """Route of the blockwise-causal backward: "kernel" or "plain" (see
    BACKWARD_ROUTES)."""
    try:
        return BACKWARD_ROUTES[backward_impl]
    except KeyError:
        raise ValueError(f"unknown backward_impl {backward_impl!r}; expected "
                         f"one of {sorted(BACKWARD_ROUTES)}") from None


def to_kernel_layout(x: torch.Tensor) -> torch.Tensor:   # (B,S,H,D) -> (B,H,S,D)
    return x.movedim(2, 1)


def from_kernel_layout(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, 2)


def divisor_block(size: int, preferred: int) -> int:
    """Largest block ≤ preferred that divides `size`, as the JAX package
    tiles its grids. Fails fast where that block would be below
    MIN_DIVISOR_BLOCK and the grid longer than MIN_DIVISOR_BLOCK steps (a
    prime or odd S), with the JAX package's words."""
    b = max(1, min(preferred, size))
    while size % b:
        b -= 1
    if b < MIN_DIVISOR_BLOCK and size // b > MIN_DIVISOR_BLOCK:
        raise ValueError(
            f"sequence length {size} has no block divisor in "
            f"[{MIN_DIVISOR_BLOCK}, {preferred}] — the kernel grid would "
            f"degrade to {b}-row blocks ({size // b} grid steps per "
            f"(batch, head)). Pad or trim the sequence so it has a divisor "
            f"≥ {MIN_DIVISOR_BLOCK} (any multiple of {MIN_DIVISOR_BLOCK} "
            f"works), or use backend='reference' for this shape.")
    return b


def check_exact_k(slots: int) -> None:
    """The exact form's compressed length, bounded as in the JAX package."""
    if slots > MAX_EXACT_K:
        raise ValueError(
            f"fused_linformer_attention requires K ≤ {MAX_EXACT_K} (the JAX "
            f"package's bound: its TPU kernel pins the whole compressed "
            f"k̄/v̄ in VMEM); got K={slots}. Lower the Linformer projected "
            f"dimension (the paper uses 128–256) or use backend='reference' "
            f"for this shape.")


def exact_smem_bytes(head_dim: int, dtype: torch.dtype, slots: int) -> int:
    """Shared memory of csrc/linformer_attn.cu. fp32: the query tile, a slot
    tile of k̄ and of v̄ (fp32, pitch Dh + 1) and the probability tile. bf16:
    two query tiles and one stage of a k̄ and a v̄ slot tile (bf16, pitch
    Dh + 8), two stages when the K slots span more than one tile."""
    kernel_dtype(dtype)
    if dtype == torch.float32:
        return 4 * ((EXACT_TILE_Q + 2 * BCA_TILE_K) * (head_dim + 1)
                    + EXACT_TILE_Q * BCA_P_PITCH)
    tile = exact_mma_tile_kv(head_dim)
    stages = 1 if slots <= tile else 2
    return 2 * (head_dim + 8) * (EXACT_MMA_Q_TILES * EXACT_MMA_TILE_Q
                                 + stages * 2 * tile)


def check_exact_shapes(*, heads: int, kv_heads: int, slots: int,
                       head_dim: int, dtype: torch.dtype) -> None:
    """Fail fast on shapes csrc/linformer_attn.cu does not take."""
    if head_dim not in EXACT_HEAD_DIMS:
        raise ValueError(f"head_dim={head_dim}: the CUDA exact Linformer "
                         f"kernel is built for head dims {EXACT_HEAD_DIMS}")
    if kv_heads <= 0 or heads % kv_heads != 0:
        raise ValueError(f"H={heads} query heads not a multiple of "
                         f"Hkv={kv_heads}")
    if slots < 1:
        raise ValueError(f"K={slots} compressed slots")
    check_exact_k(slots)
    smem = exact_smem_bytes(head_dim, dtype, slots)
    if smem > MAX_SMEM_PER_BLOCK:
        raise ValueError(f"exact Linformer tile needs {smem} B of shared "
                         f"memory, above {MAX_SMEM_PER_BLOCK}")


def seq_projection_smem_bytes(head_dim: int, dtype: torch.dtype) -> int:
    """Shared memory of csrc/seq_projection.cu. fp32: an (SP_TILE_S,
    SP_TILE_K) tile of E and an (SP_TILE_S, Dh) tile of x. bf16: two stages
    of a 64-row chunk of x (pitch Dh + 8) and of E (pitch slot tile + 8)."""
    kernel_dtype(dtype)
    if dtype == torch.float32:
        return 4 * SP_TILE_S * (SP_TILE_K + head_dim)
    return 2 * SP_MMA_STAGES * SP_MMA_CHUNK_S * (head_dim + 8
                                                 + SP_MMA_TILE_K + 8)


def check_seq_projection_shapes(*, seq: int, rows: int, slots: int,
                                head_dim: int, dtype: torch.dtype) -> None:
    """Fail fast on shapes csrc/seq_projection.cu does not take: E must
    have exactly the batch's S rows (the caller slices E[:S])."""
    if head_dim not in SP_HEAD_DIMS:
        raise ValueError(f"head_dim={head_dim}: the CUDA sequence "
                         f"projection is built for head dims {SP_HEAD_DIMS}")
    if rows != seq:
        raise ValueError(f"E has {rows} rows for a sequence of {seq}; pass "
                         "E[:S]")
    if slots < 1:
        raise ValueError(f"K={slots} projected slots")
    smem = seq_projection_smem_bytes(head_dim, dtype)
    if smem > MAX_SMEM_PER_BLOCK:
        raise ValueError(f"sequence projection tile needs {smem} B of "
                         f"shared memory, above {MAX_SMEM_PER_BLOCK}")


def bca_query_tile(block_size: int) -> int:
    """Query rows per thread block of the blockwise kernel: a tile never
    straddles two attention blocks, so it must divide c."""
    if block_size % 64 == 0:
        return 64
    if block_size % 16 == 0:
        return 16
    raise ValueError(
        f"block_size={block_size}: the CUDA blockwise-causal kernel needs "
        "a multiple of 16 (query tiles of 16 or 64 rows)")


def bca_smem_bytes(block_q: int, head_dim: int) -> int:
    return 4 * ((block_q + 2 * BCA_TILE_K) * (head_dim + 1)
                + block_q * BCA_P_PITCH)


def check_blockwise_shapes(*, seq: int, block_size: int, block_slots: int,
                           slots: int, head_dim: int, group: int,
                           dtype: torch.dtype) -> None:
    """Fail fast on shapes the training form of csrc/blockwise_causal_attn.cu
    does not take. bf16 runs the tensor-core kernel, fp32 the SIMT kernel:
    each is held to the shared memory it requests."""
    if head_dim not in BCA_HEAD_DIMS:
        raise ValueError(f"head_dim={head_dim}: the CUDA blockwise-causal "
                         f"kernel is built for head dims {BCA_HEAD_DIMS}")
    if seq % block_size != 0:
        raise ValueError(
            f"S={seq} must be a multiple of block_size={block_size}")
    if slots != (seq // block_size) * block_slots:
        raise ValueError(f"M={slots} compressed slots, expected "
                         f"(S/c)·r = {(seq // block_size) * block_slots}")
    block_q = bca_query_tile(block_size)
    if kernel_dtype(dtype) == KERNEL_DTYPES[torch.bfloat16]:
        smem, what = (bca_prefix_mma_smem_bytes(head_dim, dtype, group),
                      "tensor-core blockwise-causal tile")
    else:
        smem, what = (bca_smem_bytes(block_q, head_dim),
                      "blockwise-causal tile")
    if smem > MAX_SMEM_PER_BLOCK:
        raise ValueError(f"{what} needs {smem} B of shared memory, above "
                         f"{MAX_SMEM_PER_BLOCK}")


def bca_prefix_mma_smem_bytes(head_dim: int, slot_dtype: torch.dtype,
                              group: int) -> int:
    """Shared memory of the tensor-core prefix kernel for bf16 slots or
    int8/fp8 codes (STORAGE_DTYPES) and a GQA group of `group` query heads:
    per stage a k and a v tile of bf16 rows of pitch Dh + 8; quantized slots
    add a k and a v tile of byte rows of pitch Dh + BCA_MMA_CODE_PAD and the
    tile's k and v fp32 scales (the q tiles and the output are staged in
    these buffers)."""
    if slot_dtype != torch.bfloat16 and slot_dtype not in STORAGE_DTYPES:
        raise TypeError(f"the tensor-core prefix kernel takes bf16, int8 or "
                        f"fp8 e4m3 slots, got {slot_dtype}")
    per_stage = 2 * BCA_MMA_TILE_K * (head_dim + 8) * 2
    if slot_dtype in STORAGE_DTYPES:
        per_stage += 2 * BCA_MMA_TILE_K * (head_dim + BCA_MMA_CODE_PAD + 4)
    return bca_prefix_mma_stages(bca_prefix_mma_heads(group)) * per_stage


def check_prefix_shapes(*, seq: int, block_size: int, block_slots: int,
                        slots: int, head_dim: int, group: int,
                        dtype: torch.dtype, slot_dtype: torch.dtype) -> None:
    """Fail fast on shapes the prefix form of csrc/blockwise_causal_attn.cu
    does not take: a chunk of whole blocks against a slot buffer of any M
    (the visibility cut is clamped at M). bf16 runs the tensor-core kernel,
    fp32 the SIMT kernel: each is held to the shared memory it requests."""
    check_blockwise_shapes(seq=seq, block_size=block_size,
                           block_slots=block_slots,
                           slots=(seq // block_size) * block_slots,
                           head_dim=head_dim, group=group, dtype=dtype)
    if slots < 0:
        raise ValueError(f"M={slots} compressed slots")
    if kernel_dtype(dtype) == KERNEL_DTYPES[torch.bfloat16]:
        smem = bca_prefix_mma_smem_bytes(head_dim, slot_dtype, group)
        if smem > MAX_SMEM_PER_BLOCK:
            raise ValueError(f"tensor-core prefix tile needs {smem} B of "
                             f"shared memory, above {MAX_SMEM_PER_BLOCK}")


def check_start_blocks(start_blocks: torch.Tensor, batch: int,
                       device: torch.device) -> None:
    if start_blocks.shape != (batch,) or start_blocks.dtype != torch.int32 \
            or start_blocks.device != device \
            or not start_blocks.is_contiguous():
        raise ValueError("start_blocks: expected contiguous (B,) int32 on the "
                         f"operands' device, got {tuple(start_blocks.shape)} "
                         f"{start_blocks.dtype} on {start_blocks.device}")


def bca_bwd_smem_bytes(block_q: int, head_dim: int) -> Tuple[int, int]:
    """Shared memory of the backward's two kernels: the dq kernel (q and dO
    tiles, a key and a value tile, the dS tile) and the dk/dv kernel (key,
    value, q and dO tiles, the Pᵀ and dSᵀ tiles, three row vectors)."""
    p = head_dim + 1
    dq = 4 * (2 * block_q * p + 2 * BCA_BWD_TILE_K * p
              + block_q * BCA_BWD_S_PITCH)
    pitch = block_q + 16 if block_q % 32 == 0 else block_q
    dkdv = 4 * (4 * block_q * p + 2 * block_q * pitch + 3 * block_q)
    return dq, dkdv


def bca_bwd_mma_smem_bytes(head_dim: int) -> Tuple[int, int]:
    """Shared memory of the backward's tensor-core kernels (bf16 rows of
    pitch Dh + 8): the dq kernel (its q and dO tiles, then per stage a k and
    a v tile) and the dk/dv kernel (its k and v tiles, then per stage a q
    and a dO tile of BCA_BWD_MMA_ROW_STEP rows and their m, denom, delta)."""
    row = 2 * (head_dim + 8)
    dq = (2 * BCA_BWD_MMA_TILE_Q * row
          + BCA_BWD_MMA_STAGES * 2 * BCA_BWD_MMA_TILE_KEY * row)
    dkdv = (2 * BCA_BWD_MMA_TILE_K * row
            + BCA_BWD_MMA_STAGES * (2 * BCA_BWD_MMA_ROW_STEP * row
                                    + 3 * BCA_BWD_MMA_ROW_STEP * 4))
    return dq, dkdv


def bca_bwd_nsplit(seq: int) -> int:
    """Splits of each slot tile's rows in the tensor-core backward."""
    return -(-seq // BCA_BWD_SPLIT_ROWS)


def bca_bwd_slot_rows(tile: int, split: int, *, seq: int, block_size: int,
                      block_slots: int, start_block: int) -> Tuple[int, int]:
    """Rows [lo, hi) that split `split` of slot tile `tile` (slots
    BCA_BWD_MMA_TILE_K·tile onward) takes, for a row whose chunk starts at
    absolute block `start_block`: chunk block n sees the slots of absolute
    blocks < n + start_block, so the tile's first slot is first seen by the
    rows of block (slot // r − start_block + 1); the split cuts
    [split·BCA_BWD_SPLIT_ROWS, (split + 1)·BCA_BWD_SPLIT_ROWS) out of the
    rows from there to S. Empty (lo ≥ hi) when no row of the split sees the
    tile. The kernels (tcb::split_rows) use the same arithmetic."""
    n = (tile * BCA_BWD_MMA_TILE_K) // block_slots - start_block + 1
    first = 0 if n <= 0 else min(n * block_size, seq)
    return (max(split * BCA_BWD_SPLIT_ROWS, first),
            min((split + 1) * BCA_BWD_SPLIT_ROWS, seq))


def bca_bwd_dkdv_items(*, seq: int, block_size: int, block_slots: int,
                       slots: int, start_block: int):
    """The tensor-core dk/dv kernel's work items for one row b, in grid
    order: (kind "slot" or "local", first key or slot, valid count, rows lo,
    hi, split), the slot splits first (the last split first), then the
    local key tiles (with c a multiple of 64, every block's first tile
    first). Empty slot splits are listed too (the kernel returns at once)."""
    tk, c = BCA_BWD_MMA_TILE_K, block_size
    n_slot_tiles, nsp = -(-slots // tk), bca_bwd_nsplit(seq)
    items = []
    for item in range(n_slot_tiles * nsp):
        sp, tile = nsp - 1 - item // n_slot_tiles, item % n_slot_tiles
        lo, hi = bca_bwd_slot_rows(tile, sp, seq=seq, block_size=c,
                                   block_slots=block_slots,
                                   start_block=start_block)
        items.append(("slot", tile * tk, min(tk, slots - tile * tk), lo, hi,
                      sp))
    for li in range(-(-seq // tk)):
        if c % tk == 0:
            nb = seq // c
            key0 = (li % nb) * c + (li // nb) * tk
        else:
            key0 = li * tk
        valid = min(tk, seq - key0)
        items.append(("local", key0, valid, key0,
                      min(seq, ((key0 + valid - 1) // c + 1) * c), 0))
    return items


def bca_bwd_partials_shape(batch: int, kv_heads: int, seq: int, slots: int,
                           head_dim: int) -> Tuple[int, ...]:
    """The fp32 scratch of the tensor-core backward's slot splits: dk̄ and
    dv̄ partials of every split of every slot (2, splits, B, Hkv, M, Dh)."""
    return (2, bca_bwd_nsplit(seq), batch, kv_heads, slots, head_dim)


def check_blockwise_bwd_shapes(*, seq: int, block_size: int,
                               block_slots: int, slots: int, head_dim: int,
                               offset: bool, group: int,
                               dtype: torch.dtype) -> None:
    """Fail fast on shapes csrc/blockwise_causal_attn_bwd.cu does not take.
    Without an offset the slots are exactly (S/c)·r; with per-row start
    blocks they are a full buffer of at least that many. bf16 runs the
    tensor-core kernels, fp32 the SIMT kernels: each is held to the shared
    memory it requests."""
    nb_slots = (seq // block_size) * block_slots
    check_blockwise_shapes(seq=seq, block_size=block_size,
                           block_slots=block_slots,
                           slots=nb_slots if offset else slots,
                           head_dim=head_dim, group=group, dtype=dtype)
    if offset and slots < nb_slots:
        raise ValueError(f"M={slots} compressed slots, the offset form needs "
                         f"at least (S/c)·r = {nb_slots}")
    if kernel_dtype(dtype) == KERNEL_DTYPES[torch.bfloat16]:
        smems = bca_bwd_mma_smem_bytes(head_dim)
    else:
        smems = bca_bwd_smem_bytes(bca_query_tile(block_size), head_dim)
    for name, smem in zip(("dq", "dk/dv"), smems):
        if smem > MAX_SMEM_PER_BLOCK:
            raise ValueError(f"blockwise-causal backward {name} tile needs "
                             f"{smem} B of shared memory, above "
                             f"{MAX_SMEM_PER_BLOCK}")


def decode_splits(rows: int, group: int, keys: int) -> Tuple[int, int]:
    """(splits, 64-key tiles a split) of the decode kernels for `rows` =
    B·Hkv (row, kv head) pairs, a GQA group of `group` query heads and
    `keys` = c + M keys: enough splits for about DECODE_TARGET_BLOCKS
    blocks, at most one a tile, and no split without a tile."""
    tiles = -(-keys // DECODE_TILE)
    blocks = rows * -(-group // DECODE_GROUP_ROWS)
    want = max(1, min(tiles, -(-DECODE_TARGET_BLOCKS // blocks)))
    per = -(-tiles // want)
    return -(-tiles // per), per


def check_decode_shapes(*, group: int, head_dim: int) -> None:
    """Fail fast on shapes csrc/decode_attn.cu does not take."""
    if head_dim not in DECODE_HEAD_DIMS:
        raise ValueError(f"head_dim={head_dim}: the CUDA decode kernel is "
                         f"built for head dims {DECODE_HEAD_DIMS}")
    if not 1 <= group <= DECODE_MAX_GROUP:
        raise ValueError(f"group G={group}: the decode kernel's grid takes "
                         f"1 to {DECODE_MAX_GROUP} query heads a kv head")


PINNED_REMEDY = ("Raise block_size, lower block_slots or max_seq, or use "
                 "backend='reference' for this cache shape.")


def check_pinned_slots(name: str, slots: int, what: str, *,
                       grid_step: bool = True,
                       remedy: str = PINNED_REMEDY) -> None:
    """The JAX package's refusal of more than MAX_PINNED_SLOTS compressed
    slots, in its words (repro/kernels/ops.py): "`name` pins `what` in
    VMEM[ per grid step], which requires M ≤ 4096. `remedy`"."""
    if slots > MAX_PINNED_SLOTS:
        raise ValueError(
            f"{name} pins {what} in VMEM"
            + (" per grid step" if grid_step else "")
            + f", which requires M ≤ {MAX_PINNED_SLOTS}. {remedy}")


def kernel_dtype(dt: torch.dtype) -> int:
    """The kernels' code of one dtype (KERNEL_DTYPES)."""
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"kernels take float32 or bfloat16, got {dt}")
    return KERNEL_DTYPES[dt]


def kernel_dtype_code(*xs: torch.Tensor) -> int:
    """The kernels' dtype code; every operand must share one dtype."""
    dt = xs[0].dtype
    if any(x.dtype != dt for x in xs):
        raise TypeError("kernel operands must share one dtype, got "
                        f"{sorted({str(x.dtype) for x in xs})}")
    return kernel_dtype(dt)


def storage_dtype_code(*xs: torch.Tensor) -> int:
    """The quantized cache's storage code; every operand shares one of the
    STORAGE_DTYPES."""
    dt = xs[0].dtype
    if any(x.dtype != dt for x in xs) or dt not in STORAGE_DTYPES:
        raise TypeError("quantized cache operands must share one of "
                        f"{sorted(map(str, STORAGE_DTYPES))}, got "
                        f"{sorted({str(x.dtype) for x in xs})}")
    return STORAGE_DTYPES[dt]


def check_scales(data: torch.Tensor, *scales: torch.Tensor) -> None:
    """Per-(row, kv head, position) fp32 scales of a quantized operand in
    kernel layout: data (B, Hkv, N, Dh), each scale (B, Hkv, N), strided."""
    for s in scales:
        if s.shape != data.shape[:3] or s.dtype != torch.float32:
            raise ValueError(f"scales {tuple(s.shape)} {s.dtype}: expected "
                             f"{tuple(data.shape[:3])} float32 (B, Hkv, N)")


def same_strides(a: torch.Tensor, b: torch.Tensor):
    """The kernels take one stride set for a pair (k/v, k̄/v̄, their scales):
    contiguous copies when the two differ."""
    if a.stride() != b.stride():
        return a.contiguous(), b.contiguous()
    return a, b


def check_operands(*xs: torch.Tensor) -> None:
    """Every operand on one device, innermost dim contiguous."""
    dev = xs[0].device
    for x in xs:
        if x.device != dev:
            raise ValueError(f"operands on {x.device} and {dev}")
        if x.stride(-1) != 1:
            raise ValueError("kernel operands need a contiguous last dim, "
                             f"got strides {tuple(x.stride())}")


# -- the fake path and the kernels' costs ------------------------------------

_COST_SINKS: List[Callable[[str, int, int], None]] = []


def is_fake(x: torch.Tensor) -> bool:
    """Whether a wrapper's operand is a FakeTensor: the wrapper then takes
    its fake path (allocate, report the cost; no kernel)."""
    return isinstance(x, FakeTensor)


def kernel_route(x: torch.Tensor):
    """(kernel library, stream) of a wrapper's CUDA operand: the built
    library and the device's current stream; (None, None) for a
    FakeTensor, the fake path."""
    if is_fake(x):
        return None, None
    return build.library(), torch.cuda.current_stream(x.device).cuda_stream


@contextlib.contextmanager
def cost_sink(fn: Callable[[str, int, int], None]) -> Iterator[None]:
    """Call fn(kernel name, flops, bytes) for every fake launch in the
    block."""
    _COST_SINKS.append(fn)
    try:
        yield
    finally:
        _COST_SINKS.remove(fn)


def add_cost(name: str, cost: Tuple[int, int]) -> None:
    """Report one fake launch's (flops, bytes) to the active sinks."""
    for fn in _COST_SINKS:
        fn(name, *cost)


def visible_pairs(seq: int, block_size: int, block_slots: int,
                  start: int = 0) -> int:
    """Visible (row, key) pairs of one (batch, head) of the blockwise form:
    row t sees its own block up to itself and the r slots of every block
    before its own (shifted by `start` blocks)."""
    c, r = block_size, block_slots
    return sum((t % c) + 1 + (t // c + start) * r for t in range(seq))


def prefix_visible(seq: int, block_size: int, block_slots: int,
                   slots: int, start_blocks: Optional[Sequence[int]],
                   batch: int) -> Tuple[int, int]:
    """(visible (row, key) pairs of one head, summed over the batch rows;
    slots read, summed over the rows) of the prefix form: chunk block n of
    row b sees the slots of absolute blocks < start_blocks[b] + n, cut at
    M = `slots`. Without start blocks (a fake launch: the values are
    unknown) every row sees all M slots, the most the call can need."""
    c, r, nb = block_size, block_slots, seq // block_size
    if start_blocks is None:
        pairs = batch * sum(t % c + 1 + slots for t in range(seq))
        return pairs, batch * slots
    pairs = sum(t % c + 1 + min((s + t // c) * r, slots)
                for s in start_blocks for t in range(seq))
    read = sum(min((s + nb - 1) * r, slots) for s in start_blocks)
    return pairs, read


def decode_visible(positions: Optional[Sequence[int]], *, batch: int,
                   block_size: int, block_slots: int, slots: int) -> int:
    """Keys a decode step reads, summed over the rows: a row at position t
    sees t % c + 1 ring entries and the r slots of each completed block.
    Without positions (a fake launch) every row reads all c + M keys."""
    c, r = block_size, block_slots
    if positions is None:
        return batch * (c + slots)
    return sum(t % c + 1 + (t // c) * r for t in positions)

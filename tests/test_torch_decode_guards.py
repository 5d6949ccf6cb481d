"""The decode kernels' mirrors and guards (``repro_torch/kernels/common.py``)
against ``csrc/decode_attn.cu``, and the pinned-slot refusals the port shares
with the JAX package.

The wrapper of kernels 3 and 7 picks the key splits and sizes the split
scratch on the CPU before any launch, so its constants must be the ones the
CUDA source is built with: they are read from the source here, and the
thread layout its ``DecodeCfg`` states (one 16-byte piece of a key row a
lane) is rebuilt from them. The JAX package refuses more than
MAX_PINNED_SLOTS compressed slots in its five fused wrappers of the causal,
chunk-prefill and decode forms; the port refuses them with the same
ValueError, on CPU tensors as on CUDA ones."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import common as jcommon
from repro.kernels import ops as jops

from repro_torch.core.causal import NEG_INF
from repro_torch.kernels import common
from repro_torch.kernels import ops as tops

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "csrc" / "decode_attn.cu").read_text()


# static shared memory a block may use without cudaFuncSetAttribute
MAX_STATIC_SMEM = 48 * 1024


def decode_lanes(head_dim: int, elem_bytes: int):
    """(lanes a key row spans, key rows a lane holds, threads a block) of
    the source's DecodeCfg for a cache of `elem_bytes`-byte elements: one
    16-byte piece a lane."""
    lanes = head_dim // (16 // elem_bytes)
    keys = common.DECODE_KEYS_PER_LANE if lanes >= 2 else 2
    return lanes, keys, common.DECODE_TILE * lanes // keys


def decode_smem_bytes(head_dim: int, elem_bytes: int) -> int:
    """Static shared memory of the split kernel: each warp's merged fp32
    state (o of Dh, m, l) for the block's query rows."""
    warps = decode_lanes(head_dim, elem_bytes)[2] // 32
    return 4 * warps * common.DECODE_GROUP_ROWS * (head_dim + 2)


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, f"{name} not found in decode_attn.cu"
    return int(m.group(1))


def test_decode_mirrors_are_the_source_constants():
    assert _constant("kTile") == common.DECODE_TILE
    assert _constant("kGroupRows") == common.DECODE_GROUP_ROWS
    assert _constant("kKeysPerLane") == common.DECODE_KEYS_PER_LANE
    # the head dims the source dispatches on
    built = tuple(int(d) for d in re.findall(
        r"case (\d+): return launch<T, S, \1>", SOURCE))
    assert built == common.DECODE_HEAD_DIMS
    # the grid axis of the key splits and of the query-row blocks
    assert f"nsplit > {common.DECODE_MAX_GRID_YZ}" in SOURCE
    assert f"kGroupRows > {common.DECODE_MAX_GRID_YZ}" in SOURCE
    # the split kernel's static shared memory: each warp's merged state
    for decl in ("__shared__ float sm_o[kWarps][kGroupRows][Dh];",
                 "__shared__ float sm_m[kWarps][kGroupRows];",
                 "__shared__ float sm_l[kWarps][kGroupRows];"):
        assert decl in SOURCE


@pytest.mark.parametrize("elem_bytes", [1, 2, 4])
@pytest.mark.parametrize("head_dim", common.DECODE_HEAD_DIMS)
def test_decode_thread_layout_is_the_kernel_config(head_dim, elem_bytes):
    """DecodeCfg: kVec = 16 / sizeof(S) elements a lane, kLanes = Dh / kVec
    lanes a key row, kKeys rows a lane (2 where a row fits one lane), and
    kThreads = kTile·kLanes / kKeys; its static_asserts hold, and the
    static shared memory stays under 48 KB, for every built head dim and
    storage size."""
    lanes, keys, threads = decode_lanes(head_dim, elem_bytes)
    assert lanes * (16 // elem_bytes) == head_dim
    assert 1 <= lanes <= 32 and lanes & (lanes - 1) == 0
    assert keys == (common.DECODE_KEYS_PER_LANE if lanes >= 2 else 2)
    assert threads == common.DECODE_TILE * lanes // keys
    assert threads % 32 == 0 and threads <= 512
    warps = threads // 32
    assert decode_smem_bytes(head_dim, elem_bytes) == \
        4 * warps * common.DECODE_GROUP_ROWS * (head_dim + 2)
    assert decode_smem_bytes(head_dim, elem_bytes) <= \
        MAX_STATIC_SMEM


def test_decode_layout_at_the_full_width():
    # Dh = 128: bf16 rows over 16 lanes, 256 threads; int8/fp8 codes over
    # 8 lanes, 128 threads; fp32 over all 32 lanes, 512 threads
    assert decode_lanes(128, 2) == (16, 4, 256)
    assert decode_lanes(128, 1) == (8, 4, 128)
    assert decode_lanes(128, 4) == (32, 4, 512)
    # Dh = 16 int8: one lane a row, two rows a lane, one warp
    assert decode_lanes(16, 1) == (1, 2, 32)
    # fp32 at Dh = 128: 16 warps x 4 rows x 130 floats = 33280 B
    assert decode_smem_bytes(128, 4) == 33280


@pytest.mark.parametrize("rows,group,keys,want", [
    (32, 4, 512, (8, 1)),       # B = 4 dense decode: 256 blocks
    (8, 4, 512, (8, 1)),        # B = 1 remainder step: 64 blocks
    (32, 4, 544, (9, 1)),       # B = 4 paged gather, M = 288: 288 blocks
    (4, 2, 40, (1, 1)),         # the SMOKE shape: one tile, no combine
    (32, 4, 4352, (9, 8)),      # M = 4096: 68 tiles, 8 a split
    (2, 6, 128, (2, 1)),        # G = 6: two blocks of query rows a head
])
def test_decode_splits_at_the_serving_shapes(rows, group, keys, want):
    assert common.decode_splits(rows, group, keys) == want


@pytest.mark.parametrize("rows", [1, 8, 32, 264])
@pytest.mark.parametrize("group", [1, 4, 6])
@pytest.mark.parametrize("keys", [1, 65, 544, 4352])
def test_decode_splits_cover_the_tiles(rows, group, keys):
    """The C entry's checks: every split holds a tile, the splits cover
    them all; at least half of DECODE_TARGET_BLOCKS blocks, or one split a
    tile (splits hold whole, equal runs of tiles, so the count rounds)."""
    nsplit, per = common.decode_splits(rows, group, keys)
    tiles = -(-keys // common.DECODE_TILE)
    assert nsplit >= 1 and per >= 1
    assert (nsplit - 1) * per < tiles <= nsplit * per
    blocks = nsplit * rows * -(-group // common.DECODE_GROUP_ROWS)
    assert 2 * blocks >= min(
        common.DECODE_TARGET_BLOCKS,
        2 * tiles * rows * -(-group // common.DECODE_GROUP_ROWS))


def test_decode_guards():
    for dh in common.DECODE_HEAD_DIMS:
        common.check_decode_shapes(group=4, head_dim=dh)
    common.check_decode_shapes(group=4096, head_dim=128)
    for dh in (8, 48, 256):
        with pytest.raises(ValueError, match="head dims"):
            common.check_decode_shapes(group=4, head_dim=dh)
    for g in (0, common.DECODE_MAX_GROUP + 1):
        with pytest.raises(ValueError, match="group"):
            common.check_decode_shapes(group=g, head_dim=64)


# -- the pinned-slot refusals, both packages ---------------------------------

C, R, DH = 16, 16, 16


def _arrays(shapes, rng):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _causal(pkg, M, rng):
    S = M // R * C                              # M = (S/c)·r
    q, k, v, E, F = _arrays([(1, S, 1, DH), (1, S, 1, DH), (1, S, 1, DH),
                                (C, R), (C, R)], rng)
    kw = dict(block_size=C, block_slots=R, scale=DH ** -0.5)
    if pkg == "jax":
        return lambda: jops.fused_blockwise_causal_attention(
            *map(jnp.asarray, (q, k, v, E, F)), **kw)
    return lambda: tops.fused_blockwise_causal_attention(
        *map(torch.from_numpy, (q, k, v, E, F)), **kw)


def _chunk(pkg, M, rng, quantized=False):
    q, k, v, ck, cv = _arrays([(1, C, 1, DH)] * 3 + [(1, M, 1, DH)] * 2,
                              rng)
    kw = dict(block_size=C, block_slots=R, scale=DH ** -0.5)
    start = np.zeros(1, np.int32)
    if quantized:
        ck, cv = (np.clip(np.round(x * 40), -127, 127).astype(np.int8)
                  for x in (ck, cv))
        scales = [np.full((1, M, 1), 0.025, np.float32)] * 2
        if pkg == "jax":
            return lambda: jops.fused_chunk_prefill_attention_q(
                *map(jnp.asarray, (q, k, v, ck, cv, *scales, start)), **kw)
        return lambda: tops.fused_chunk_prefill_attention_q(
            *map(torch.from_numpy, (q, k, v, ck, cv, *scales, start)), **kw)
    if pkg == "jax":
        return lambda: jops.fused_chunk_prefill_attention(
            *map(jnp.asarray, (q, k, v, ck, cv, start)), **kw)
    return lambda: tops.fused_chunk_prefill_attention(
        *map(torch.from_numpy, (q, k, v, ck, cv, start)), **kw)


def _decode(pkg, M, rng, quantized=False):
    q, rk, rv, ck, cv = _arrays([(1, 1, 2, DH)] + [(1, C, 1, DH)] * 2
                                + [(1, M, 1, DH)] * 2, rng)
    bl = np.where(np.arange(C)[None] <= 5, 0.0, NEG_INF).astype(np.float32)
    bg = np.where(np.arange(M)[None] < M - R, 0.0,
                  NEG_INF).astype(np.float32)
    sc = dict(scale=DH ** -0.5)
    if quantized:
        rk, rv, ck, cv = (np.clip(np.round(x * 40), -127, 127).astype(np.int8)
                          for x in (rk, rv, ck, cv))
        rs = [np.full((1, C, 1), 0.025, np.float32)] * 2
        cs = [np.full((1, M, 1), 0.025, np.float32)] * 2
        args = (q, rk, rv, *rs, ck, cv, *cs, bl, bg)
        if pkg == "jax":
            return lambda: jops.fused_decode_attention_q(
                *map(jnp.asarray, args), **sc)
        return lambda: tops.fused_decode_attention_q(
            *map(torch.from_numpy, args), **sc)
    args = (q, rk, rv, ck, cv, bl, bg)
    if pkg == "jax":
        return lambda: jops.fused_decode_attention(*map(jnp.asarray, args),
                                                   **sc)
    return lambda: tops.fused_decode_attention(*map(torch.from_numpy, args),
                                               **sc)


FORMS = {
    "fused_blockwise_causal_attention": _causal,
    "fused_chunk_prefill_attention": _chunk,
    "fused_chunk_prefill_attention_q":
        lambda pkg, M, rng: _chunk(pkg, M, rng, quantized=True),
    "fused_decode_attention": _decode,
    "fused_decode_attention_q":
        lambda pkg, M, rng: _decode(pkg, M, rng, quantized=True),
}


def test_the_port_keeps_the_jax_bound():
    assert common.MAX_PINNED_SLOTS == jcommon.MAX_PINNED_SLOTS == 4096


@pytest.mark.parametrize("form", list(FORMS))
def test_both_packages_refuse_more_pinned_slots(form):
    """M = 4112 (one block of r = 16 slots past the bound): both packages
    raise the same ValueError before any work."""
    M = common.MAX_PINNED_SLOTS + R
    errors = {}
    for pkg in ("jax", "torch"):
        call = FORMS[form](pkg, M, np.random.default_rng(0))
        with pytest.raises(ValueError, match="requires M ≤ 4096") as exc:
            call()
        errors[pkg] = str(exc.value)
    assert errors["torch"] == errors["jax"]
    assert errors["torch"].startswith(form + " pins ")


@pytest.mark.parametrize("form", list(FORMS))
def test_the_port_takes_the_bound_itself(form):
    """M = 4096 passes the port's wrapper (the plain twins on the CPU), with
    a finite output."""
    out = FORMS[form]("torch", common.MAX_PINNED_SLOTS,
                      np.random.default_rng(1))()
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("form", ["fused_decode_attention",
                                  "fused_decode_attention_q"])
def test_both_decode_forms_agree_at_the_bound(form):
    """At M = 4096 the JAX decode kernels (interpret mode) take the same
    operands as the port and agree with it within 1e-5."""
    M = common.MAX_PINNED_SLOTS
    want = FORMS[form]("jax", M, np.random.default_rng(2))()
    got = FORMS[form]("torch", M, np.random.default_rng(2))()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)

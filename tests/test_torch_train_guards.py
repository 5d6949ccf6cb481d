"""The training pair's tensor-core routes (kernels 1 and 1r in bf16 on
``bca_prefix_mma_kernel`` of ``csrc/blockwise_causal_attn.cu``; kernel 2 in
bf16 on the dq, dk/dv and reduction kernels of namespace tcb in
``csrc/blockwise_causal_attn_bwd.cu``): their shared-memory mirrors and
guards (``repro_torch/kernels/common.py``) against the sources, the slot
split schedule of the backward, the two-term bf16 split that carries its
fp32 P and dS through the tensor cores, and the plain twins the card holds
the kernels to, against the JAX kernels at the training form's edges.

The guards run on the CPU before any launch, so the bytes they compute
must be the bytes the sources request: the tile constants are read from
the sources and their ``Layout`` structs evaluated for every head dim. The
dk/dv kernel cuts the rows of each slot tile into splits and writes fp32
partials that a reduction pass sums; its Python mirror
(``bca_bwd_dkdv_items``) must give every visible (key or slot, row) pair
to exactly one block, for every shape and start block. On the card,
``chip_smoke.py`` ``[check]`` and ``tests/test_torch_gpu.py`` hold the
kernels to the twins at TRAIN_EDGE_SHAPES; here the twins meet the JAX
package's Pallas kernels (interpret mode) at the edges that fit the CPU:
c = 16 and 32 (64-row and 64-key tiles spanning blocks), a ragged S, G = 1
and 3, start blocks. Tolerances (fp32): 1e-5 absolute for outputs, maxima
and gradients, 1e-5 relative for denominators."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import blockwise_causal_attn as jbca

from repro_torch.kernels import blockwise_causal_attn as tbca
from repro_torch.kernels import common

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
FWD = (CSRC / "blockwise_causal_attn.cu").read_text()
BWD = (CSRC / "blockwise_causal_attn_bwd.cu").read_text()
TCB = BWD[BWD.index("namespace tcb {"):]
TCB = TCB[:TCB.index("}  // namespace tcb")]
SM_SMEM = 228 * 1024          # an H100 SM's shared memory, 1 KB kept a block
ATOL = 1e-5


def _constants(text: str) -> dict:
    """`constexpr int kName = <integer expression>;` lines of `text` that
    do not depend on a template argument, evaluated in order."""
    env: dict = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", text):
        if re.fullmatch(r"[\w\s*+]+", expr) and all(
                w.isdigit() or w in env for w in re.findall(r"\w+", expr)):
            env[name] = eval(expr, {}, dict(env))
    return env


def _bwd_layout(head_dim: int) -> dict:
    """The backward source's tcb::Layout<Dh> evaluated: its `static
    constexpr int` members in order."""
    body = TCB[TCB.index("struct Layout {"):]
    body = body[:body.index("};")]
    env = dict(_constants(TCB), Dh=head_dim)
    for name, expr in re.findall(r"static constexpr int (k\w+) = ([^;]+);",
                                 body):
        env[name] = eval(expr, {}, dict(env))
    return env


# -- shared memory and tiles ---------------------------------------------------


def test_backward_tile_constants_are_the_mirrors():
    tcb = _constants(TCB)
    assert tcb["kWarps"] == common.BCA_BWD_MMA_WARPS
    assert tcb["kThreads"] == 32 * common.BCA_BWD_MMA_WARPS
    assert tcb["kTileK"] == common.BCA_BWD_MMA_TILE_K == 64
    assert tcb["kRowStep"] == common.BCA_BWD_MMA_ROW_STEP
    assert tcb["kTileQ"] == common.BCA_BWD_MMA_TILE_Q
    assert tcb["kTileKey"] == common.BCA_BWD_MMA_TILE_KEY
    assert tcb["kStages"] == common.BCA_BWD_MMA_STAGES
    assert tcb["kSplitRows"] == common.BCA_BWD_SPLIT_ROWS
    # splits are whole row steps, and the head dims the kernels dispatch on
    assert tcb["kSplitRows"] % tcb["kRowStep"] == 0
    built = tuple(int(d) for d in re.findall(
        r"case (\d+): return launch_mma<\1>\(p, stream\);", BWD))
    assert built == common.BCA_HEAD_DIMS
    # the launches request the Layout's bytes; two blocks an SM
    assert "allow_smem(dq_kernel, L::kDqBytes)" in BWD
    assert "allow_smem(kv_kernel, L::kDkdvBytes)" in BWD
    assert BWD.count("__launch_bounds__(tcb::kThreads, 2)") == 2


@pytest.mark.parametrize("head_dim", common.BCA_HEAD_DIMS)
def test_backward_smem_mirror_is_the_kernel_layout(head_dim):
    lay = _bwd_layout(head_dim)
    assert lay["kPitch"] == head_dim + 8
    dq, dkdv = common.bca_bwd_mma_smem_bytes(head_dim)
    assert (dq, dkdv) == (lay["kDqBytes"], lay["kDkdvBytes"])
    # the two blocks an SM the launch bounds ask for fit its shared memory
    assert 2 * (max(dq, dkdv) + 1024) <= SM_SMEM
    common.check_blockwise_bwd_shapes(
        seq=4096, block_size=256, block_slots=16, slots=256,
        head_dim=head_dim, offset=False, group=4, dtype=torch.bfloat16)


def test_backward_smem_at_the_train_shape():
    # Dh = 128: 136-element rows. dq: the 64-row q and dO tiles and two
    # stages of a 64-key k and v tile, 102 KB; dk/dv: the 64-key k and v
    # tiles and two stages of 32-row q and dO tiles with their m, denom and
    # delta, 68.75 KB
    assert common.bca_bwd_mma_smem_bytes(128) == (
        2 * 64 * 272 + 2 * 2 * 64 * 272, 2 * 64 * 272 + 2 * (
            2 * 32 * 272 + 3 * 32 * 4)) == (104448, 70400)


@pytest.mark.parametrize("group", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("head_dim", common.BCA_HEAD_DIMS)
def test_forward_training_form_is_held_to_its_route(head_dim, group):
    """bf16 kernels 1 and 1r run the tensor-core kernel: the guard holds
    them to its shared memory (the prefix kernel's, bf16 slots); fp32 to
    the SIMT kernel's."""
    heads = common.bca_prefix_mma_heads(group)
    want = common.bca_prefix_mma_stages(heads) * 2 * 64 * (head_dim + 8) * 2
    assert common.bca_prefix_mma_smem_bytes(head_dim, torch.bfloat16,
                                            group) == want
    for dtype in (torch.float32, torch.bfloat16):
        common.check_blockwise_shapes(
            seq=4096, block_size=256, block_slots=16, slots=256,
            head_dim=head_dim, group=group, dtype=dtype)


def test_sources_route_by_dtype_without_fallback():
    """bf16 calls go to the tensor-core kernels whatever the form; fp32 to
    the SIMT kernels; no SIMT kernel is built for bf16."""
    fwd = FWD[FWD.index('extern "C" int bca_forward('):]
    assert "if (dtype == kFloat32) return dispatch_slots<float>" in fwd
    assert "return dispatch_prefix_mma(p, B, Dh, slot_dtype, s);" in fwd
    assert "dispatch_tile<__nv_bfloat16" not in FWD
    assert "p.start_blocks == nullptr ? 0 : p.start_blocks[b]" in FWD
    bwd = BWD[BWD.index('extern "C" int bca_backward('):]
    assert "return dispatch_simt(p, s);" in bwd
    assert "return dispatch_mma(p, s);" in bwd
    assert "<__nv_bfloat16, Dh, BQ>" not in BWD
    assert tbca.ROUTES == {0: "simt", 1: "tensor cores"}


# -- guards ---------------------------------------------------------------------


def _bwd_operands(B=2, H=4, Hkv=2, S=64, c=16, r=4, Dh=16, M=None,
                  dtype=torch.bfloat16):
    M = (S // c) * r if M is None else M
    q = torch.zeros(B, H, S, Dh, dtype=dtype)
    kv = [torch.zeros(B, Hkv, n, Dh, dtype=dtype) for n in (S, S, M, M)]
    res = [torch.ones(B, H, S) for _ in range(2)]
    return (q, *kv, *res, torch.zeros_like(q)), dict(block_size=c,
                                                      block_slots=r,
                                                      scale=0.25)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("change,error,match", [
    (dict(Dh=48), ValueError, "head dims"),
    (dict(c=24, S=72, r=4), ValueError, "multiple of 16"),
    (dict(M=20), ValueError, r"M=20 compressed slots, expected \(S/c\)·r"),
])
def test_backward_guards_refuse_in_the_wrappers_words(change, error, match,
                                                      dtype):
    """The backward wrapper refuses before any launch (the library is never
    touched), in both dtypes."""
    args, kw = _bwd_operands(dtype=dtype, **change)
    with pytest.raises(error, match=match):
        tbca.launch_bwd(None, *args, stream=None, **kw)


def test_backward_guards_refuse_operands():
    args, kw = _bwd_operands()
    q, k, v, kb, vb, m, d, do = args
    with pytest.raises(ValueError, match="at least"):
        tbca.launch_bwd(None, q, k, v, kb[:, :, :8], vb[:, :, :8], m, d, do,
                        stream=None, start_blocks=torch.zeros(
                            2, dtype=torch.int32), **kw)
    with pytest.raises(ValueError, match="start_blocks"):
        tbca.launch_bwd(None, *args, stream=None, start_blocks=torch.zeros(
            2, dtype=torch.int64), **kw)
    with pytest.raises(ValueError, match="m: expected contiguous"):
        tbca.launch_bwd(None, q, k, v, kb, vb, m.transpose(1, 2).contiguous()
                        .transpose(1, 2), d, do, stream=None, **kw)
    with pytest.raises(TypeError, match="one dtype"):
        tbca.launch_bwd(None, q, k, v, kb, vb, m, d, do.float(), stream=None,
                        **kw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tbca.launch_bwd(None, *(x.half() if x.dtype == torch.bfloat16 else x
                                for x in args), stream=None, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("change,match", [
    (dict(Dh=48), "head dims"),
    (dict(c=24, S=72, r=4), "multiple of 16"),
    (dict(M=12), "compressed slots"),
])
def test_forward_guards_refuse_in_the_wrappers_words(change, match, dtype):
    args, kw = _bwd_operands(dtype=dtype, **change)
    with pytest.raises(ValueError, match=match):
        tbca.launch(None, *args[:5], stream=None, **kw)


def test_partials_are_sized_by_the_splits():
    assert common.bca_bwd_nsplit(4096) == 8
    assert common.bca_bwd_nsplit(513) == 2
    assert common.bca_bwd_nsplit(96) == 1
    # the train step's scratch: 8 splits of dk̄ and dv̄ partials, 33.6 MB
    shape = common.bca_bwd_partials_shape(2, 8, 4096, 256, 128)
    assert shape == (2, 8, 2, 8, 256, 128)
    assert 4 * np.prod(shape) == 33554432


# -- the slot split schedule ---------------------------------------------------


def _coverage(S, c, r, M, start):
    """Per (key or slot, row): how many dk/dv items of one row b cover it,
    for the local keys (S, S) and the slots (M, S)."""
    loc = np.zeros((S, S), np.int32)
    glob = np.zeros((M, S), np.int32)
    for kind, key0, valid, lo, hi, _ in common.bca_bwd_dkdv_items(
            seq=S, block_size=c, block_slots=r, slots=M, start_block=start):
        if lo >= hi:
            continue
        (glob if kind == "slot" else loc)[key0:key0 + valid, lo:hi] += 1
    return loc, glob


def _visible(S, c, r, M, start):
    rows = np.arange(S)
    keys = np.arange(S)
    loc = (keys[:, None] <= rows[None]) & (keys[:, None] // c
                                           == rows[None] // c)
    glob = np.arange(M)[:, None] // r < rows[None] // c + start
    return loc, glob


def _schedule_cases():
    rng = np.random.default_rng(18)
    cases = [(4096, 256, 16, 256, 0), (1024, 64, 16, 256, 0),
             (1024, 64, 16, 256, 1), (96, 16, 4, 24, 0), (144, 48, 4, 12, 0),
             (1040, 16, 4, 300, 7), (512, 512, 16, 16, 0)]
    for _ in range(24):
        c = int(rng.choice([16, 32, 48, 64, 128, 256]))
        nb = int(rng.integers(1, 2048 // c + 1))
        r = int(rng.choice([1, 2, 4, 8, 16, 32]))
        start = int(rng.integers(0, 12))
        M = nb * r + int(rng.integers(0, 3)) * int(rng.integers(0, 64))
        cases.append((nb * c, c, r, M, start))
    return cases


@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("S,c,r,M,start", _schedule_cases())
def test_split_schedule_covers_every_visible_pair_once(S, c, r, M, start,
                                                       G):
    """Every visible (key, row) and (slot, row) pair of each of the G query
    heads of a kv head lies in exactly one block's range (a block walks all
    G heads over its rows); invisible pairs inside a range are masked by
    the kernel. A slot no row sees lies in no non-empty split, which is
    what gives it exact zeros."""
    loc, glob = _coverage(S, c, r, M, start)
    vis_loc, vis_glob = _visible(S, c, r, M, start)
    assert np.all(np.tile(loc[vis_loc], G) == 1)
    assert np.all(np.tile(glob[vis_glob], G) == 1)
    assert loc.max() <= 1 and glob.max() <= 1
    # the reduction sums the splits that hold rows for a slot's tile: every
    # row that sees the slot lies in one of them
    nsp = common.bca_bwd_nsplit(S)
    for m in range(0, M, max(1, M // 17)):
        tile = m // common.BCA_BWD_MMA_TILE_K
        held = set()
        for sp in range(nsp):
            lo, hi = common.bca_bwd_slot_rows(
                tile, sp, seq=S, block_size=c, block_slots=r,
                start_block=start)
            if hi > lo:
                held.add(sp)
        seen = np.flatnonzero(vis_glob[m])
        assert set(seen // common.BCA_BWD_SPLIT_ROWS) <= held


def test_split_schedule_orders_the_heaviest_first():
    """At the train step's shapes: the slot splits first, the last split
    first; then every attention block's first 64-key tile (it sees c rows)
    before any second tile; and the first split of the last slot tiles
    holds no row (they are first seen at rows 2304 and 3328)."""
    items = common.bca_bwd_dkdv_items(seq=4096, block_size=256,
                                      block_slots=16, slots=256,
                                      start_block=0)
    kinds = [it[0] for it in items]
    n_slot = kinds.count("slot")
    assert n_slot == 4 * 8 and kinds[:n_slot] == ["slot"] * n_slot
    splits = [it[5] for it in items[:n_slot]]
    assert splits == sorted(splits, reverse=True)
    local = items[n_slot:]
    assert len(local) == 64
    assert [it[1] % 256 for it in local[:16]] == [0] * 16
    assert [it[4] - it[3] for it in local] == sorted(
        (it[4] - it[3] for it in local), reverse=True)
    by = {(it[1], it[5]): (it[3], it[4]) for it in items[:n_slot]}
    assert by[192, 0][0] >= by[192, 0][1]          # tile 3, split 0: empty
    assert by[192, 6] == (3328, 3584)
    assert by[0, 0] == (256, 512)
    # the rows the slot splits take: tile t (slots of blocks 4t .. 4t + 3)
    # takes the rows of blocks 4t + 1 on, 15 + 11 + 7 + 3 blocks in all; 20
    # of the 32 splits hold rows
    held = [hi - lo for lo, hi in by.values() if hi > lo]
    assert len(held) == 4 * 8 - 12 and sum(held) == 256 * (15 + 11 + 7 + 3)


# -- the two-term bf16 split ---------------------------------------------------


def _split(x: torch.Tensor):
    """x (fp32) as hi = bf16(x) and lo = bf16(x - hi), both in fp32: what
    the kernels' split_bf16x2 packs (round to nearest even, as torch)."""
    hi = x.to(torch.bfloat16).float()
    rest = x - hi
    return hi, rest, rest.to(torch.bfloat16).float()


@pytest.mark.parametrize("kind", ["P", "dS", "tiny"])
def test_two_term_split_keeps_an_fp32_operand(kind):
    """|x − (hi + lo)| ≤ 2^-17·|x| for probabilities in [0, 1], dS of both
    signs over many binades, and tiny magnitudes down to 2^-100 (where lo
    is still a normal number); x − hi is exact in fp32; zeros stay zeros."""
    g = torch.Generator().manual_seed(17)
    if kind == "P":
        x = torch.rand(1 << 16, generator=g) ** 4
    elif kind == "dS":
        x = torch.randn(1 << 16, generator=g) * torch.exp2(
            torch.randint(-40, 20, (1 << 16,), generator=g).float())
    else:
        x = torch.randn(1 << 16, generator=g).sign() * torch.exp2(
            -100 + 60 * torch.rand(1 << 16, generator=g))
    x = torch.cat([x, torch.zeros(4), -x[:16]])
    hi, rest, lo = _split(x)
    assert torch.equal(hi + rest, x)                  # x - hi is exact
    err = (x.double() - (hi.double() + lo.double())).abs()
    assert torch.all(err <= 2.0 ** -17 * x.double().abs())
    # one bf16 term alone (up to 2^-9 relative) misses that bound
    assert torch.any((x - hi).abs() > 2.0 ** -17 * x.abs())


# -- the plain twins against the JAX kernels at the training form's edges -----

# (B, H, Hkv, S, c, r, Dh), start blocks (None: the training form, M =
# (S/c)·r), M of the offset form's full buffer
EDGES = {
    "c16_dh16_g1": ((2, 2, 2, 96, 16, 4, 16), None, None),
    "c32_dh32_g3": ((2, 6, 2, 128, 32, 8, 32), None, None),
    "offset_c16_ragged": ((2, 4, 2, 96, 16, 4, 32), [0, 5], 48),
}


def _edge_inputs(name, seed):
    (B, H, Hkv, S, c, r, Dh), start, M = EDGES[name]
    M = (S // c) * r if M is None else M
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, H, S, Dh), f(B, Hkv, S, Dh), f(B, Hkv, S, Dh),
            f(B, Hkv, M, Dh), f(B, Hkv, M, Dh), f(B, H, S, Dh))


def _kw(name):
    c, r, Dh = EDGES[name][0][4:]
    return dict(block_size=c, block_slots=r, scale=Dh ** -0.5)


@pytest.mark.parametrize("name", [n for n in EDGES if EDGES[n][1] is None])
def test_training_forward_twin_matches_jax_at_the_edges(name):
    """Kernels 1 and 1r's plain twin (the wrapper on CPU tensors) against
    the JAX kernel in both forms."""
    q, k, v, kb, vb, _ = _edge_inputs(name, seed=40)
    kw = _kw(name)
    out_j, m_j, d_j = jbca.blockwise_causal_attn(
        *map(jnp.asarray, (q, k, v, kb, vb)), interpret=True,
        return_residuals=True, **kw)
    n0 = (tbca.blockwise_causal_attn.launches,
          tbca.blockwise_causal_attn.residual_launches)
    xs = [torch.from_numpy(x) for x in (q, k, v, kb, vb)]
    out, m, d = tbca.blockwise_causal_attn(*xs, return_residuals=True, **kw)
    plain = tbca.blockwise_causal_attn(*xs, **kw)
    assert (tbca.blockwise_causal_attn.launches,
            tbca.blockwise_causal_attn.residual_launches) == n0
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=ATOL)
    assert torch.equal(plain, out)


@pytest.mark.parametrize("name", list(EDGES))
def test_backward_twin_matches_jax_at_the_edges(name):
    """Kernel 2's plain twin against the JAX kernel from the JAX forward's
    residuals: all five gradients, exact zeros on slots no row sees."""
    q, k, v, kb, vb, do = _edge_inputs(name, seed=41)
    start = EDGES[name][1]
    kw = _kw(name)
    if start is None:
        _, m, d = jbca.blockwise_causal_attn(
            *map(jnp.asarray, (q, k, v, kb, vb)), interpret=True,
            return_residuals=True, **kw)
        sb_j = sb = None
    else:
        sb_j = jnp.asarray(start, jnp.int32)
        _, m, d = jbca.blockwise_causal_prefix_attn(
            *map(jnp.asarray, (q, k, v, kb, vb)), sb_j, interpret=True,
            return_residuals=True, **kw)
        sb = torch.tensor(start, dtype=torch.int32)
    m, d = np.asarray(m), np.asarray(d)
    want = jbca.blockwise_causal_attn_bwd(
        *map(jnp.asarray, (q, k, v, kb, vb, m, d, do)), interpret=True,
        start_blocks=sb_j, **kw)
    n0 = tbca.blockwise_causal_attn_bwd.launches
    got = tbca.blockwise_causal_attn_bwd(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, kb, vb, m, d, do)),
        start_blocks=sb, **kw)
    assert tbca.blockwise_causal_attn_bwd.launches == n0
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)
    invisible = np.all(np.asarray(want[3]) == 0, axis=-1)
    assert invisible.any()
    for g_ in got[3:]:
        assert torch.all(g_[torch.from_numpy(invisible)] == 0)

"""The prefix form's tensor-core kernel (kernels 4, 4r and 8 in bf16,
``csrc/blockwise_causal_attn.cu``, namespace tc): its shared-memory mirror
and guards (``repro_torch/kernels/common.py``) against the source, the
exactness of its quantized-slot design, and the plain twins it is checked
against on the card, held here against the JAX kernels at the same edges.

The guard runs on the CPU before any launch, so the bytes it computes must
be the bytes the source requests: the tile constants are read from the
source and its ``Layout`` is evaluated for every head dim and slot dtype.
The kernel lands int8 and fp8 e4m3 codes in shared memory as bf16 and
applies the fp32 scales outside its products; that is exact because every
int8 code and every finite e4m3 code is a bf16 value, checked here for all
of them. On the card, ``chip_smoke.py`` ``[check]`` and
``tests/test_torch_gpu.py`` hold the kernel against the plain twins at
PREFIX_EDGE_SHAPES; here the twins meet the JAX package's Pallas kernels
(interpret mode) at the edges that fit the CPU: c = 16 and 32 (a 64-row
query tile spanning blocks), Dh 16 and 32, G = 1 and 3, a cut clamped at
M, a start block at M/r - 1, and M = 0. Tolerances (fp32): 1e-5 absolute
for outputs and maxima, 1e-5 relative for denominators."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.kernels import blockwise_causal_attn as jbca

from repro_torch.kernels import blockwise_causal_attn as tbca
from repro_torch.kernels import common

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "csrc" / "blockwise_causal_attn.cu").read_text()
TC = SOURCE[SOURCE.index("namespace tc {"):]
SLOT_DTYPES = [torch.bfloat16, torch.int8, torch.float8_e4m3fn]
SM_SMEM = 228 * 1024          # an H100 SM's shared memory, 1 KB kept a block
ATOL = 1e-5

# (B, H, Hkv, P, c, r, Dh), start blocks, M: chip_smoke's PREFIX_EDGE_SHAPES
# that fit the CPU. c16_dh16_g1: a 96-row chunk of 16-row blocks (the
# kernel's second query tile is ragged), row 1's cut clamped at M
# ((9 + 5)·4 = 56 > 48); c32_dh32_g3: G = 3; last_start: a start block at
# M/r - 1; m0: no slots.
EDGES = {
    "c16_dh16_g1": ((2, 2, 2, 96, 16, 4, 16), [0, 9], 48),
    "c32_dh32_g3": ((2, 6, 2, 128, 32, 8, 32), [2, 7], 120),
    "last_start": ((2, 4, 2, 64, 32, 8, 32), [7, 0], 64),
    "m0": ((2, 4, 2, 64, 16, 4, 32), [0, 3], 0),
}


def _tc_constants() -> dict:
    """`constexpr int kName = <integer expression>;` lines of the source's
    namespace tc that do not depend on the head dim, evaluated in order."""
    env: dict = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", TC):
        if re.fullmatch(r"[\w\s*+]+", expr) and "Dh" not in expr \
                and all(w.isdigit() or w in env
                        for w in re.findall(r"\w+", expr)):
            env[name] = eval(expr, {}, dict(env))
    return env


def _tc_function(name: str):
    """`constexpr int name(int heads) { return <expr>; }` of namespace tc,
    as a Python function of heads (C's `a ? b : c` read as Python's)."""
    m = re.search(rf"constexpr int {name}\(int heads\) {{ return ([^;]+); }}",
                  TC)
    assert m, f"{name} not found"
    expr = re.sub(r"^(.+) \? (.+) : (.+)$", r"(\2) if \1 else (\3)",
                  m.group(1))
    env = _tc_constants()
    return lambda heads: eval(expr, {}, dict(env, heads=heads))


def _layout(head_dim: int, slot_dtype: torch.dtype, heads: int) -> dict:
    """The source's tc::Layout<Dh, S, Heads> evaluated: its `static
    constexpr` members in order, C's `a ? b : c` read as Python's."""
    body = TC[TC.index("struct Layout {"):]
    body = body[:body.index("};")]
    env = dict(_tc_constants(), Dh=head_dim, Heads=heads,
               stages=_tc_function("stages"))
    for _, name, expr in re.findall(
            r"static constexpr (int|bool) (k\w+) = ([^;]+);", body):
        if name == "kQuant":
            assert expr == "!std::is_same<S, __nv_bfloat16>::value"
            env[name] = slot_dtype != torch.bfloat16
            continue
        expr = re.sub(r"^(\w+) \? (.+) : (.+)$", r"(\2) if \1 else (\3)",
                      expr)
        env[name] = eval(expr, {}, dict(env))
    return env


def test_tile_constants_are_the_mirrors():
    tc = _tc_constants()
    assert tc["kTileQ"] == 16 * tc["kWarpsPerHead"] == common.BCA_MMA_TILE_Q
    assert tc["kTileK"] == common.BCA_MMA_TILE_K
    assert tc["kCodePad"] == common.BCA_MMA_CODE_PAD
    assert tc["kMaxHeads"] == 2
    threads, stages = _tc_function("threads"), _tc_function("stages")
    for heads in (1, 2):
        assert threads(heads) == 128 * heads
        assert stages(heads) == common.bca_prefix_mma_stages(heads)
    # two heads a block for an even group, else one
    assert ("if ((p.H / p.Hkv) % 2 == 0) "
            "return dispatch_prefix_head_dim<S, 2>") in SOURCE
    assert [common.bca_prefix_mma_heads(g) for g in (1, 2, 3, 4, 6)] == \
        [1, 2, 1, 2, 2]
    # the head dims the tensor-core kernel dispatches on
    built = tuple(int(d) for d in re.findall(
        r"case (\d+): return launch_prefix_mma<S, \1, Heads>", SOURCE))
    assert built == common.BCA_HEAD_DIMS
    # the launch requests the Layout's bytes; one head a block asks for two
    # blocks an SM, two heads for one
    assert "constexpr size_t smem = tc::Layout<Dh, S, Heads>::kSmemBytes;" \
        in SOURCE
    assert "__launch_bounds__(tc::threads(Heads), 2 / Heads)" in SOURCE


@pytest.mark.parametrize("group", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("slot_dtype", SLOT_DTYPES, ids=str)
@pytest.mark.parametrize("head_dim", common.BCA_HEAD_DIMS)
def test_smem_mirror_is_the_kernel_layout(head_dim, slot_dtype, group):
    heads = common.bca_prefix_mma_heads(group)
    lay = _layout(head_dim, slot_dtype, heads)
    assert lay["kPitch"] == head_dim + 8
    assert common.bca_prefix_mma_smem_bytes(head_dim, slot_dtype, group) \
        == lay["kSmemBytes"]
    # the blocks the launch bounds ask for fit an SM's shared memory
    assert (2 // heads) * (lay["kSmemBytes"] + 1024) <= SM_SMEM
    common.check_prefix_shapes(seq=512, block_size=256, block_slots=16,
                               slots=288, head_dim=head_dim, group=group,
                               dtype=torch.bfloat16, slot_dtype=slot_dtype)


def test_smem_mirror_at_the_serving_shape():
    # qwen3-8b, G = 4: two heads a block, three stages of a 64-key k and v
    # tile of 136-element rows: 102 KB; int8/fp8 slots add 144-byte code
    # rows and 64 + 64 fp32 scales a stage: 157.5 KB
    assert common.bca_prefix_mma_smem_bytes(128, torch.bfloat16, 4) == \
        3 * 2 * 64 * 136 * 2 == 104448
    for dt in (torch.int8, torch.float8_e4m3fn):
        assert common.bca_prefix_mma_smem_bytes(128, dt, 4) == \
            104448 + 3 * 2 * (64 * 144 + 64 * 4) == 161280


def test_prefix_guards_refuse_what_the_kernels_do_not_take():
    kw = dict(seq=64, block_slots=4, slots=40, group=2,
              dtype=torch.bfloat16, slot_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        common.check_prefix_shapes(block_size=16, head_dim=48, **kw)
    with pytest.raises(ValueError, match="multiple of 16"):
        common.check_prefix_shapes(block_size=8, head_dim=64, **kw)
    with pytest.raises(ValueError, match="M=-1"):
        common.check_prefix_shapes(block_size=16, head_dim=64,
                                   **dict(kw, slots=-1))
    with pytest.raises(TypeError, match="int8 or fp8"):
        common.check_prefix_shapes(block_size=16, head_dim=64,
                                   **dict(kw, slot_dtype=torch.float32))
    # the fp32 route (SIMT) takes every slot dtype the wrapper passes it
    common.check_prefix_shapes(block_size=16, head_dim=64,
                               **dict(kw, dtype=torch.float32,
                                      slot_dtype=torch.int8))


def test_every_int8_code_is_a_bf16_value():
    codes = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    want = codes.to(torch.float32)
    assert torch.equal(codes.to(torch.bfloat16).to(torch.float32), want)


def test_every_finite_e4m3_code_is_a_bf16_value():
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
        torch.float8_e4m3fn)
    want = codes.to(torch.float32)
    finite = torch.isfinite(want)
    assert int(finite.sum()) == 254               # 0x7f and 0xff are NaN
    got = codes.to(torch.float32).to(torch.bfloat16).to(torch.float32)
    assert torch.equal(got[finite], want[finite])


def _edge_inputs(name, seed):
    """Kernel-layout numpy operands of one edge: q (B, H, P, Dh), k, v
    (B, Hkv, P, Dh), an fp32 slot buffer (B, Hkv, M, Dh) for k̄ and v̄, the
    start blocks."""
    (B, H, Hkv, P, c, r, Dh), start, M = EDGES[name]
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, H, P, Dh), f(B, Hkv, P, Dh), f(B, Hkv, P, Dh),
            f(B, Hkv, M, Dh) * 2, f(B, Hkv, M, Dh) * 2,
            np.asarray(start, np.int32))


def _jax_prefix(name, xs, **kw):
    """The JAX Pallas kernel (interpret) on one edge's operands. At M = 0 it
    has nothing to reduce over and raises, so each block then takes its
    own block alone: a one-block chunk at start block 0, whose slots (a
    dummy buffer of r) its cut hides."""
    (B, H, Hkv, P, c, r, Dh), _, M = EDGES[name]
    if M:
        return jbca.blockwise_causal_prefix_attn(
            *map(jnp.asarray, xs), interpret=True, **kw)
    q, k, v, _, _, _ = xs
    slots = jnp.ones((B, Hkv, r, Dh), jnp.float32)
    zero = jnp.zeros(B, jnp.int32)
    parts = [jbca.blockwise_causal_prefix_attn(
        *(jnp.asarray(x[:, :, n * c:(n + 1) * c]) for x in (q, k, v)),
        slots, slots, zero, interpret=True, **kw) for n in range(P // c)]
    if kw.get("return_residuals"):
        return tuple(jnp.concatenate([p_[i] for p_ in parts], 2)
                     for i in range(3))
    return jnp.concatenate(parts, 2)


@pytest.mark.parametrize("residuals", [False, True])
@pytest.mark.parametrize("name", list(EDGES))
def test_prefix_twin_matches_jax_at_the_edges(name, residuals):
    """Kernel 4's plain twin (the wrapper on CPU tensors), both forms,
    against the JAX kernel."""
    (_, _, _, _, c, r, Dh), _, _ = EDGES[name]
    xs = _edge_inputs(name, seed=30)
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5,
              return_residuals=residuals)
    want = _jax_prefix(name, xs, **kw)
    n0 = tbca.blockwise_causal_prefix_attn.launches
    got = tbca.blockwise_causal_prefix_attn(*map(torch.from_numpy, xs),
                                            **kw)
    assert tbca.blockwise_causal_prefix_attn.launches == n0   # no kernel
    if not residuals:
        got, want = (got,), (want,)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=ATOL, rtol=0)
    if residuals:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-5)


def _to_torch(x):
    """A JAX code or scale array as a torch tensor; fp8 through its bits."""
    a = np.asarray(x)
    if a.dtype.itemsize == 1 and a.dtype != np.int8:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("page_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("name", [n for n in EDGES if EDGES[n][2]])
def test_prefix_q_twin_matches_jax_at_the_edges(name, page_dtype):
    """Kernel 8's plain twin on the codes and scales the JAX quantizer
    makes, against the JAX kernel (M = 0 has no JAX counterpart: the
    quantized kernel has no slot-free form to compare with)."""
    (_, _, _, _, c, r, Dh), _, _ = EDGES[name]
    q, k, v, ck, cv, sb = _edge_inputs(name, seed=31)
    pdt, qmax = jcache.resolve_page_dtype(page_dtype)
    (ckq, cks), (cvq, cvs) = (jcache.quantize_blockwise(
        jnp.asarray(x), (3,), dtype=pdt, qmax=qmax) for x in (ck, cv))
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    want = jbca.blockwise_causal_prefix_attn_q(
        *map(jnp.asarray, (q, k, v)), ckq, cvq, cks, cvs, jnp.asarray(sb),
        interpret=True, **kw)
    n0 = tbca.blockwise_causal_prefix_attn_q.launches
    got = tbca.blockwise_causal_prefix_attn_q(
        *map(torch.from_numpy, (q, k, v)),
        *map(_to_torch, (ckq, cvq, cks, cvs)), torch.from_numpy(sb), **kw)
    assert tbca.blockwise_causal_prefix_attn_q.launches == n0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("page_dtype", ["int8", "fp8"])
def test_prefix_q_twin_at_m0_is_the_dense_twin(page_dtype):
    """M = 0 over quantized slots: no slot is read, so kernel 8's twin gives
    kernel 4's twin's output over an empty fp32 slot buffer."""
    (_, _, _, _, c, r, Dh), _, _ = EDGES["m0"]
    q, k, v, ck, cv, sb = map(torch.from_numpy, _edge_inputs("m0", seed=32))
    dt = torch.int8 if page_dtype == "int8" else torch.float8_e4m3fn
    codes = ck.to(dt)
    scales = torch.ones(ck.shape[:3])
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    got = tbca.blockwise_causal_prefix_attn_q(q, k, v, codes, codes, scales,
                                              scales, sb, **kw)
    want = tbca.blockwise_causal_prefix_attn(q, k, v, ck, cv, sb, **kw)
    assert torch.equal(got, want)

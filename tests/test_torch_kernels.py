"""Parity of the PyTorch port's attention kernels' plain versions with the
JAX package, on the CPU in fp32.

The same numpy inputs (seeded) go through the JAX functions — the Pallas
kernel wrappers in interpret mode and the pure-jnp references — and through
the port's plain versions: its core/causal.py references and the plain
twins that its kernel wrappers run for CPU tensors. Tolerance: 1e-5
absolute (fp32, different summation orders)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import causal as jcausal
from repro.kernels import ops as jops

from repro_torch.core import causal as tcausal
from repro_torch.kernels import blockwise_causal_attn as tbca
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import linformer_attn as tla
from repro_torch.kernels import ops as tops
from repro_torch.parallel import plan as tplan

ATOL = 1e-5
B, H, HKV, DH, C, R = 2, 4, 2, 16, 16, 4


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(a_torch, b_jax, atol=ATOL):
    np.testing.assert_allclose(a_torch.detach().numpy(), np.asarray(b_jax),
                               atol=atol, rtol=0)


def _prefill_inputs(per_head: bool, S: int = 64, seed: int = 0):
    rng = np.random.default_rng(seed)
    q, k, v = _np(rng, B, S, H, DH), _np(rng, B, S, HKV, DH), \
        _np(rng, B, S, HKV, DH)
    shape = (HKV, C, R) if per_head else (C, R)
    E, F = _np(rng, *shape) * R ** -0.5, _np(rng, *shape) * R ** -0.5
    return q, k, v, E, F


@pytest.mark.parametrize("per_head", [False, True])
def test_blockwise_reference_matches_jax(per_head):
    q, k, v, E, F = _prefill_inputs(per_head)
    sc = DH ** -0.5
    want = jcausal.blockwise_causal_attention(
        *map(jnp.asarray, (q, k, v, E, F)), block_size=C, scale=sc)
    want_fused = jops.fused_blockwise_causal_attention(
        *map(jnp.asarray, (q, k, v, E, F)), block_size=C, block_slots=R,
        scale=sc)
    got = tcausal.blockwise_causal_attention(
        *map(torch.from_numpy, (q, k, v, E, F)), block_size=C, scale=sc)
    _close(got, want)
    _close(got, want_fused)


@pytest.mark.parametrize("per_head", [False, True])
def test_blockwise_kernel_plain_matches_jax(per_head):
    """The port's kernel wrapper on CPU tensors runs the kernel's plain
    twin: compared with the JAX Pallas kernel (interpret) and reference."""
    q, k, v, E, F = _prefill_inputs(per_head, seed=1)
    sc = DH ** -0.5
    want_fused = jops.fused_blockwise_causal_attention(
        *map(jnp.asarray, (q, k, v, E, F)), block_size=C, block_slots=R,
        scale=sc)
    want_ref = jcausal.blockwise_causal_attention(
        *map(jnp.asarray, (q, k, v, E, F)), block_size=C, scale=sc)
    launches = tbca.blockwise_causal_attn.launches
    got = tops.fused_blockwise_causal_attention(
        *map(torch.from_numpy, (q, k, v, E, F)), block_size=C,
        block_slots=R, scale=sc)
    _close(got, want_fused)
    _close(got, want_ref)
    assert tbca.blockwise_causal_attn.launches == launches   # no kernel


def test_blockwise_first_block_sees_no_slots():
    """Block 0 has no visible compressed slot: its rows equal exact causal
    attention over the block alone (slots set to garbage must not leak)."""
    q, k, v, E, F = _prefill_inputs(False, S=32, seed=2)
    qt, kt, vt = (tcommon.to_kernel_layout(torch.from_numpy(x))
                  for x in (q, k, v))
    kbar = torch.full((B, HKV, 2 * R, DH), 1e3)
    out = tbca.blockwise_causal_attn_plain(
        qt, kt, vt, kbar, -kbar, block_size=C, block_slots=R,
        scale=DH ** -0.5)
    q0, k0, v0 = (torch.from_numpy(x[:, :C]) for x in (q, k, v))
    kk = k0.repeat_interleave(H // HKV, 2)
    vv = v0.repeat_interleave(H // HKV, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q0, kk) * DH ** -0.5
    s = s.masked_fill(~torch.ones(C, C, dtype=torch.bool).tril(), -1e30)
    exact = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vv)
    np.testing.assert_allclose(
        tcommon.from_kernel_layout(out)[:, :C].numpy(), exact.numpy(),
        atol=ATOL, rtol=0)


# rows: (t = tokens already cached) -> pos = t % c, blk = t // c
DECODE_T = [0, 7, 15, 3 + 2 * C, 5 * C + C - 1, 2 * C]


def _decode_inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    Bd = len(DECODE_T)
    M = 6 * R
    q = _np(rng, Bd, 1, H, DH)
    rk, rv = _np(rng, Bd, C, HKV, DH), _np(rng, Bd, C, HKV, DH)
    ck, cv = _np(rng, Bd, M, HKV, DH), _np(rng, Bd, M, HKV, DH)
    t = np.asarray(DECODE_T)
    loc_ok = np.arange(C)[None, :] <= (t % C)[:, None]
    glob_ok = np.arange(M)[None, :] < ((t // C) * R)[:, None]
    return q, rk, rv, ck, cv, loc_ok, glob_ok


def test_decode_reference_matches_jax():
    q, rk, rv, ck, cv, lo, go = _decode_inputs()
    sc = DH ** -0.5
    want = jcausal.masked_decode_attention(
        *map(jnp.asarray, (q, rk, rv, ck, cv, lo, go)), scale=sc)
    got = tcausal.masked_decode_attention(
        *map(torch.from_numpy, (q, rk, rv, ck, cv, lo, go)), scale=sc)
    _close(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_kernel_plain_matches_jax(seed):
    q, rk, rv, ck, cv, lo, go = _decode_inputs(seed)
    sc = DH ** -0.5
    bl = np.where(lo, 0.0, -1e30).astype(np.float32)
    bg = np.where(go, 0.0, -1e30).astype(np.float32)
    want_fused = jops.fused_decode_attention(
        *map(jnp.asarray, (q, rk, rv, ck, cv, bl, bg)), scale=sc)
    want_ref = jcausal.masked_decode_attention(
        *map(jnp.asarray, (q, rk, rv, ck, cv, lo, go)), scale=sc)
    launches = tla.decode_attn.launches
    got = tops.fused_decode_attention(
        *map(torch.from_numpy, (q, rk, rv, ck, cv, bl, bg)), scale=sc)
    _close(got, want_fused)
    _close(got, want_ref)
    assert tla.decode_attn.launches == launches


def test_plan_routes_on_cpu():
    """'auto' and 'reference' run on CPU tensors and agree; 'fused' needs
    CUDA tensors and raises."""
    q, rk, rv, ck, cv, lo, go = map(torch.from_numpy, _decode_inputs(3))
    outs = [tplan.as_plan(b).decode_attention(q, rk, rv, ck, cv, lo, go,
                                              scale=0.25)
            for b in ("auto", "reference")]
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=ATOL)
    with pytest.raises(ValueError, match="needs CUDA"):
        tplan.as_plan("fused").decode_attention(q, rk, rv, ck, cv, lo, go,
                                                scale=0.25)
    with pytest.raises(ValueError, match="unknown attention backend"):
        tplan.as_plan("pallas")


def test_cuda_requested_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        tcommon.resolve_device("cuda")
    assert tcommon.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("kw,match", [
    (dict(seq=64, block_size=16, block_slots=4, slots=16, head_dim=48),
     "head_dim"),
    (dict(seq=60, block_size=16, block_slots=4, slots=12, head_dim=16),
     "multiple"),
    (dict(seq=64, block_size=16, block_slots=4, slots=12, head_dim=16),
     "compressed slots"),
    (dict(seq=72, block_size=24, block_slots=4, slots=12, head_dim=16),
     "multiple of 16"),
])
def test_blockwise_kernel_guards(kw, match):
    with pytest.raises(ValueError, match=match):
        tcommon.check_blockwise_shapes(**kw)


def test_kernel_guards_accept_main_path_shapes():
    tcommon.check_blockwise_shapes(seq=1024, block_size=256, block_slots=16,
                                   slots=64, head_dim=128)
    tcommon.check_blockwise_shapes(seq=32, block_size=16, block_slots=4,
                                   slots=8, head_dim=16)
    tcommon.check_decode_shapes(group=4, head_dim=128)
    with pytest.raises(ValueError, match="shared memory"):
        tcommon.check_decode_shapes(group=4096, head_dim=128)
    with pytest.raises(TypeError, match="one dtype"):
        tcommon.kernel_dtype_code(torch.zeros(1), torch.zeros(1).bfloat16())

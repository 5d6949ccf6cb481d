"""Parity of the PyTorch port's attention kernels' plain versions with the
JAX package, on the CPU in fp32.

The same numpy inputs (seeded) go through the JAX functions — the Pallas
kernel wrappers in interpret mode and the pure-jnp references — and through
the port's plain versions: its core/causal.py references and the plain
twins that its kernel wrappers run for CPU tensors. Tolerance: 1e-5
absolute (fp32, different summation orders); 1e-5 relative for the softmax
denominators, which grow with the row length."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import causal as jcausal
from repro.kernels import blockwise_causal_attn as jbca
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
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match=match):
            tcommon.check_blockwise_shapes(**kw, group=2, dtype=dtype)


def test_kernel_guards_accept_main_path_shapes():
    for dtype in (torch.float32, torch.bfloat16):
        tcommon.check_blockwise_shapes(seq=1024, block_size=256,
                                       block_slots=16, slots=64, head_dim=128,
                                       group=4, dtype=dtype)
        tcommon.check_blockwise_shapes(seq=32, block_size=16, block_slots=4,
                                       slots=8, head_dim=16, group=2,
                                       dtype=dtype)
    tcommon.check_decode_shapes(group=4, head_dim=128)
    with pytest.raises(ValueError, match="group"):
        tcommon.check_decode_shapes(group=tcommon.DECODE_MAX_GROUP + 1,
                                    head_dim=128)
    with pytest.raises(TypeError, match="one dtype"):
        tcommon.kernel_dtype_code(torch.zeros(1), torch.zeros(1).bfloat16())


# -- training: residual-emitting forward (1r) and backward (2) ----------------


def _kernel_inputs(G, S, seed, M=None):
    """Kernel-layout operands: q (B, H, S, DH), k/v (B, H/G, S, DH), slots
    (B, H/G, M, DH) (M = (S/C)·R unless given), dO like q."""
    rng = np.random.default_rng(seed)
    hkv = H // G
    M = M or (S // C) * R
    return (_np(rng, B, H, S, DH), _np(rng, B, hkv, S, DH),
            _np(rng, B, hkv, S, DH), _np(rng, B, hkv, M, DH),
            _np(rng, B, hkv, M, DH), _np(rng, B, H, S, DH))


@pytest.mark.parametrize("G", [1, 2])
def test_residual_forward_plain_matches_jax(G):
    q, k, v, kb, vb, _ = _kernel_inputs(G, 64, seed=4 + G)
    kw = dict(block_size=C, block_slots=R, scale=DH ** -0.5)
    out_j, m_j, d_j = jbca.blockwise_causal_attn(
        *map(jnp.asarray, (q, k, v, kb, vb)), interpret=True,
        return_residuals=True, **kw)
    launches = tbca.blockwise_causal_attn.residual_launches
    out, m, d = tbca.blockwise_causal_attn(
        *map(torch.from_numpy, (q, k, v, kb, vb)), return_residuals=True,
        **kw)
    assert tbca.blockwise_causal_attn.residual_launches == launches
    _close(out, out_j)
    _close(m, m_j)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=ATOL)
    # the residual form's output is the plain form's
    plain = tbca.blockwise_causal_attn(
        *map(torch.from_numpy, (q, k, v, kb, vb)), **kw)
    assert torch.equal(plain, out)


def _jax_residuals(q, k, kb, vb, v, start, kw):
    """(m, denom) of the JAX forward: the offset form's when `start` is
    given (a full slot buffer), else the plain form's."""
    if start is None:
        _, m, d = jbca.blockwise_causal_attn(
            *map(jnp.asarray, (q, k, v, kb, vb)), interpret=True,
            return_residuals=True, **kw)
    else:
        _, m, d = jbca.blockwise_causal_prefix_attn(
            *map(jnp.asarray, (q, k, v, kb, vb)),
            jnp.asarray(start, jnp.int32), interpret=True,
            return_residuals=True, **kw)
    return np.asarray(m), np.asarray(d)


@pytest.mark.parametrize("G,S,start", [
    (1, 32, None),                 # MHA, S = 2c
    (2, 64, None),                 # GQA
    (2, 32, [1, 3]),               # GQA, nonzero per-row start blocks
    (1, 48, [0, 2]),
])
def test_backward_plain_matches_jax(G, S, start):
    M = None if start is None else (max(start) + S // C) * R + R
    q, k, v, kb, vb, do = _kernel_inputs(G, S, seed=7 + S, M=M)
    kw = dict(block_size=C, block_slots=R, scale=DH ** -0.5)
    m, d = _jax_residuals(q, k, kb, vb, v, start, kw)
    want = jbca.blockwise_causal_attn_bwd(
        *map(jnp.asarray, (q, k, v, kb, vb, m, d, do)), interpret=True,
        start_blocks=None if start is None else jnp.asarray(start,
                                                            jnp.int32),
        **kw)
    sb = None if start is None else torch.tensor(start, dtype=torch.int32)
    launches = tbca.blockwise_causal_attn_bwd.launches
    got = tbca.blockwise_causal_attn_bwd(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, kb, vb, m, d, do)),
        start_blocks=sb, **kw)
    assert tbca.blockwise_causal_attn_bwd.launches == launches
    for g, w in zip(got, want):
        _close(g, w)
    # slots no query row sees: exact zeros, in both packages
    invisible = np.all(np.asarray(want[3]) == 0, axis=-1)
    assert invisible.any()
    assert torch.all(got[3][torch.from_numpy(invisible)] == 0)
    assert torch.all(got[4][torch.from_numpy(invisible)] == 0)


def _grad_inputs(per_head, G, S, seed):
    rng = np.random.default_rng(seed)
    hkv = H // G
    shape = (hkv, C, R) if per_head else (C, R)
    return (_np(rng, B, S, H, DH), _np(rng, B, S, hkv, DH),
            _np(rng, B, S, hkv, DH), _np(rng, *shape) * R ** -0.5,
            _np(rng, *shape) * R ** -0.5, _np(rng, B, S, H, DH))


@pytest.mark.parametrize("backward_impl", ["fused", "reference"])
@pytest.mark.parametrize("per_head,G", [(False, 1), (False, 2), (True, 2)])
def test_attention_grads_match_jax(per_head, G, backward_impl):
    """torch.autograd through the port's fused_blockwise_causal_attention
    (its Function runs the twins on the CPU) against jax.grad of the JAX
    one (Pallas forward and backward in interpret mode): dq/dk/dv/dE/dF.
    dq/dk/dv within 1e-5 absolute; dE/dF sum over every block of every row
    (entries ~10), so they are held to 1e-5 of their largest entry."""
    q, k, v, E, F, do = _grad_inputs(per_head, G, 64, seed=11 + G)
    kw = dict(block_size=C, block_slots=R, scale=DH ** -0.5)

    def f(*xs):
        out = jops.fused_blockwise_causal_attention(*xs, **kw)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (q, k, v, E, F)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, E, F)]
    launches = (tbca.blockwise_causal_attn.residual_launches,
                tbca.blockwise_causal_attn_bwd.launches)
    out = tops.fused_blockwise_causal_attention(
        *xs, backward_impl=backward_impl, **kw)
    got = torch.autograd.grad(out, xs, torch.from_numpy(do))
    assert launches == (tbca.blockwise_causal_attn.residual_launches,
                        tbca.blockwise_causal_attn_bwd.launches)
    for name, g, w in zip("q k v E F".split(), got, want):
        w = np.asarray(w)
        scale = np.abs(w).max() if name in "EF" else 1.0
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL * scale, rtol=0,
                                   err_msg=name)


def test_fused_route_uses_the_function_only_under_grad(monkeypatch):
    """The Function (residual forward + backward kernel) runs only when
    autograd records; "reference" routes gradients through the plain
    reference form and never reaches the Function."""
    q, k, v, E, F, _ = _grad_inputs(False, 2, 32, seed=3)
    kw = dict(block_size=C, block_slots=R, scale=DH ** -0.5)
    calls = []
    real = tops.BlockwiseCausalAttnFn.apply
    monkeypatch.setattr(tops.BlockwiseCausalAttnFn, "apply",
                        lambda *a: calls.append(1) or real(*a))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, E, F)]
    with torch.no_grad():
        tops.fused_blockwise_causal_attention(*xs, **kw)
    assert calls == []
    tops.fused_blockwise_causal_attention(*xs, **kw).sum().backward()
    assert calls == [1]
    tops.fused_blockwise_causal_attention(
        *xs, backward_impl="reference", **kw).sum().backward()
    assert calls == [1]
    with pytest.raises(ValueError, match="unknown backward_impl"):
        tops.fused_blockwise_causal_attention(*xs, backward_impl="pallas",
                                              **kw)
    with pytest.raises(ValueError, match="unknown backward_impl"):
        tplan.AttentionPlan(backward_impl="pallas")


@pytest.mark.parametrize("kw,match", [
    (dict(seq=64, block_size=16, block_slots=4, slots=16, head_dim=48,
          offset=False), "head_dim"),
    (dict(seq=64, block_size=16, block_slots=4, slots=20, head_dim=16,
          offset=False), "compressed slots"),
    (dict(seq=64, block_size=16, block_slots=4, slots=12, head_dim=16,
          offset=True), "at least"),
])
def test_backward_kernel_guards(kw, match):
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match=match):
            tcommon.check_blockwise_bwd_shapes(**kw, group=2, dtype=dtype)


def test_backward_guards_accept_main_path_shapes():
    for dtype in (torch.float32, torch.bfloat16):
        tcommon.check_blockwise_bwd_shapes(seq=4096, block_size=256,
                                           block_slots=16, slots=256,
                                           head_dim=128, offset=False,
                                           group=4, dtype=dtype)
        tcommon.check_blockwise_bwd_shapes(seq=32, block_size=16,
                                           block_slots=4, slots=40,
                                           head_dim=16, offset=True, group=2,
                                           dtype=dtype)
    dq, dkdv = tcommon.bca_bwd_smem_bytes(64, 128)
    assert max(dq, dkdv) <= tcommon.MAX_SMEM_PER_BLOCK
    assert max(tcommon.bca_bwd_mma_smem_bytes(128)) <= \
        tcommon.MAX_SMEM_PER_BLOCK

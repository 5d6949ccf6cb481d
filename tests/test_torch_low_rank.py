"""Parity of the port's spectrum analysis (``repro_torch/core/low_rank.py``,
paper §3 Figure 1 and Theorems 1–2) with the JAX package, on the CPU in
fp32.

The same numpy inputs go to both packages. Tolerances: 1e-5 absolute on P,
the cumulative spectrum and the energies (fp32 SVDs of two libraries);
`rank_for_energy` equal as an integer; the JL and Theorem-2 errors given
JAX's own R (rebuilt here as ``jax.random.normal(key, (k, n)) / sqrt(k)``)
within 1e-5 relative, as are the errors of the port's own draws against
their helpers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import low_rank as jlr

from repro_torch.core import low_rank as tlr

TOL = 1e-5
S, DH = 64, 16


def _qk(seed, sharp):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((S, DH)) * sharp).astype(np.float32)
    k = rng.standard_normal((S, DH)).astype(np.float32)
    return q, k


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sharp", [0.3, 1.0, 3.0])
def test_context_mapping_and_spectrum_match_jax(sharp, causal):
    q, k = _qk(int(10 * sharp) + causal, sharp)
    Pj = jlr.context_mapping(jnp.asarray(q), jnp.asarray(k), causal=causal)
    Pt = tlr.context_mapping(torch.from_numpy(q), torch.from_numpy(k),
                             causal=causal)
    _close(Pt, Pj)
    _close(tlr.cumulative_spectrum(Pt), jlr.cumulative_spectrum(Pj))
    for rank in (1, 8, S // 4, S):
        _close(tlr.energy_at_rank(Pt, rank), jlr.energy_at_rank(Pj, rank))
    for energy in (0.5, 0.9, 0.99):
        assert int(tlr.rank_for_energy(Pt, energy)) == \
            int(jlr.rank_for_energy(Pj, energy))


def test_batched_heads_equal_one_head_at_a_time():
    """The port's leading batch of heads (the card's per-layer call) gives
    each head's own spectrum."""
    qs, ks = zip(*(_qk(s, 1.0) for s in range(3)))
    q, k = torch.from_numpy(np.stack(qs)), torch.from_numpy(np.stack(ks))
    P = tlr.context_mapping(q, k)
    e = tlr.energy_at_rank(P, 16)
    r = tlr.rank_for_energy(P, 0.9)
    for h in range(3):
        Ph = tlr.context_mapping(q[h], k[h])
        torch.testing.assert_close(P[h], Ph, rtol=0, atol=1e-7)
        _close(e[h], tlr.energy_at_rank(Ph, 16))
        assert int(r[h]) == int(tlr.rank_for_energy(Ph, 0.9))


def _jax_r(key, k, n):
    return np.array(jax.random.normal(key, (k, n), jnp.float32)
                    / jnp.sqrt(k))


@pytest.mark.parametrize("kdim", [8, 32])
def test_jl_projection_error_given_jax_r(kdim):
    q, k = _qk(3, 1.0)
    P = jlr.context_mapping(jnp.asarray(q), jnp.asarray(k))
    w = np.random.default_rng(4).standard_normal(S).astype(np.float32)
    key = jax.random.PRNGKey(kdim)
    want = float(jlr.jl_projection_error(key, P, jnp.asarray(w), kdim))
    got = float(tlr.jl_projection_error_given_r(
        torch.from_numpy(np.array(P)), torch.from_numpy(w),
        torch.from_numpy(_jax_r(key, kdim, S))))
    np.testing.assert_allclose(got, want, rtol=TOL)


@pytest.mark.parametrize("kdim", [8, 32])
def test_theorem2_error_given_jax_r(kdim):
    rng = np.random.default_rng(5)
    a_row = rng.standard_normal(S).astype(np.float32)
    V = rng.standard_normal((S, DH)).astype(np.float32)
    key = jax.random.PRNGKey(100 + kdim)
    ej, rj = jlr.theorem2_error(key, jnp.asarray(a_row), jnp.asarray(V),
                                kdim)
    et, rt = tlr.theorem2_error_given_r(
        torch.from_numpy(a_row), torch.from_numpy(V),
        torch.from_numpy(_jax_r(key, kdim, S)))
    np.testing.assert_allclose(float(et), float(ej), rtol=TOL)
    np.testing.assert_allclose(float(rt), float(rj), rtol=TOL)


def test_random_functions_draw_r_from_the_generator():
    """The public functions draw R (k, n), N(0, 1/k), from the generator:
    the same seed gives the helper's value on the same R; another seed
    another error."""
    q, k = _qk(6, 1.0)
    P = tlr.context_mapping(torch.from_numpy(q), torch.from_numpy(k))
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(S)
                         .astype(np.float32))
    V = torch.from_numpy(np.random.default_rng(8).standard_normal((S, DH))
                         .astype(np.float32))
    R = torch.randn((16, S), generator=torch.Generator().manual_seed(1)) \
        / 4.0
    got = tlr.jl_projection_error(torch.Generator().manual_seed(1), P, w, 16)
    torch.testing.assert_close(got, tlr.jl_projection_error_given_r(P, w, R))
    assert got != tlr.jl_projection_error(torch.Generator().manual_seed(2),
                                          P, w, 16)
    e, r = tlr.theorem2_error(torch.Generator().manual_seed(1), P[0], V, 16)
    e2, r2 = tlr.theorem2_error_given_r(P[0], V, R)
    torch.testing.assert_close((e, r), (e2, r2))

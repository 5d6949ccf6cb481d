"""Parity of the PyTorch port's SSM blocks with the JAX package on the CPU:
Mamba2 (models/mamba2.py) and RWKV6 (models/rwkv6.py), fp32, the same
inputs from numpy and the JAX weights bridged.

Mamba2: the chunked SSD at Lc = chunk and at JAX's Lc = S fallback,
``return_state`` and ``step_mamba2`` against JAX's. RWKV6: ``time_mix``,
``step_time_mix`` and ``channel_mix`` against JAX's at the SMOKE chunk
(16) and lengths it divides, where JAX's chunked form is finite; and where
it is not (a single chunk of S = 90 or 100 at the SMOKE chunk, chunk 128
at S = 256), the port's capped chunks stay finite and equal JAX's stepwise
``step_time_mix`` loop, the recurrence both forms compute.

Tolerances, absolute: 1e-5 on the Mamba2 outputs and states and on the
RWKV6 shifts and channel mix; 1e-4 on RWKV6 outputs and states (its
chunked form multiplies factors up to e^32 at chunk 16 and sums them in
another order than the stepwise loop or JAX's einsums)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RWKVConfig as JRWKVConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import mamba2 as jm2
from repro.models import rwkv6 as jr6

from repro_torch.configs.base import RWKVConfig, SSMConfig
from repro_torch.models import mamba2 as tm2
from repro_torch.models import rwkv6 as tr6
from repro_torch.models.transformer import nest

from test_torch_dense_configs import _flatten_j

SSM = dict(state_dim=8, head_dim=8, expand=2, conv_width=4, chunk_size=16)
D_MAMBA = 32
RWKV_SMOKE = dict(head_dim=16, chunk_size=16)
D_RWKV, FF_RWKV = 64, 128


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port while this module runs: its small
    ops gain nothing from more, and under the test run's parallel workers
    more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.fixture(scope="module")
def mamba():
    p = jm2.init_mamba2(jax.random.PRNGKey(0), D_MAMBA, JSSMConfig(**SSM),
                        jnp.float32)
    return p, nest({k: _t(v) for k, v in _flatten_j(p).items()})


@pytest.mark.parametrize("S", [32, 24])
def test_mamba2_chunked_matches_jax(mamba, S):
    """S = 32: two chunks of 16; S = 24: JAX's Lc = S fallback. The output
    and, with return_state, the SSM state and the conv tail."""
    pj, pt = mamba
    x = _x((2, S, D_MAMBA), seed=S)
    yj, stj = jm2.apply_mamba2(pj, jnp.asarray(x), JSSMConfig(**SSM),
                               return_state=True)
    yt, stt = tm2.apply_mamba2(pt, _t(x), SSMConfig(**SSM),
                               return_state=True)
    _close(yt, yj, 1e-5)
    _close(stt["ssm"], stj["ssm"], 1e-5)
    _close(stt["conv"], stj["conv"], 1e-5)
    _close(tm2.apply_mamba2(pt, _t(x), SSMConfig(**SSM)), yj, 1e-5)


def test_mamba2_steps_match_jax(mamba):
    """12 steps of step_mamba2 from a random state: every output and the
    state after each step; the port's scan equals its chunked form; the
    causal conv with a left context (decode's) equals JAX's."""
    pj, pt = mamba
    x = _x((2, 12, D_MAMBA), seed=3)
    d_inner = SSM["expand"] * D_MAMBA
    H = d_inner // SSM["head_dim"]
    stj = {"ssm": jnp.asarray(_x((2, H, SSM["state_dim"], SSM["head_dim"]),
                                 seed=4)),
           "conv": jnp.asarray(_x((2, 3, d_inner + 2 * SSM["state_dim"]),
                                  seed=5))}
    stt = {k: _t(v) for k, v in stj.items()}
    for k, v in tm2.init_mamba2_state(2, D_MAMBA, SSMConfig(**SSM),
                                      device="cpu").items():
        want = jm2.init_mamba2_state(2, D_MAMBA, JSSMConfig(**SSM))[k]
        assert v.shape == want.shape and not v.any(), k
        assert str(v.dtype) == f"torch.{want.dtype}", k
    for t in range(12):
        yj, stj = jm2.step_mamba2(pj, jnp.asarray(x[:, t:t + 1]), stj,
                                  JSSMConfig(**SSM))
        yt, stt = tm2.step_mamba2(pt, _t(x[:, t:t + 1]), stt,
                                  SSMConfig(**SSM))
        _close(yt, yj, 1e-5)
        for k in ("ssm", "conv"):
            _close(stt[k], stj[k], 1e-5)
    _close(tm2.apply_mamba2_scan(pt, _t(x), SSMConfig(**SSM)),
           jm2.apply_mamba2(pj, jnp.asarray(x), JSSMConfig(**SSM)), 2e-5)
    xbc = _x((2, 12, d_inner + 2 * SSM["state_dim"]), seed=6)
    conv = np.asarray(stj["conv"])
    _close(tm2._causal_conv(_t(xbc), pt["conv_w"], pt["conv_b"], _t(conv)),
           jm2._causal_conv(jnp.asarray(xbc), pj["conv_w"], pj["conv_b"],
                            jnp.asarray(conv)), 1e-5)


def _rwkv(d_model, d_ff, head_dim, seed=0, spread=True):
    """JAX's init_rwkv6 and its bridge. With `spread`, a decay base that
    spreads the per-step log decay over [-2, 0) (the init's 0 gives -1 a
    step everywhere)."""
    cfg = JRWKVConfig(head_dim=head_dim, chunk_size=16)
    p = jr6.init_rwkv6(jax.random.PRNGKey(seed), d_model, d_ff, cfg,
                       jnp.float32)
    if spread:
        base = np.linspace(-3.0, 0.6, d_model).astype(np.float32)
        p = dict(p, decay_base=jnp.asarray(base))
    return p, nest({k: _t(v) for k, v in _flatten_j(p).items()})


@pytest.fixture(scope="module")
def rwkv():
    return _rwkv(D_RWKV, FF_RWKV, RWKV_SMOKE["head_dim"])


def _states(B, D, P, seed):
    H = D // P
    return (_x((B, D), seed), _x((B, H, P, P), seed + 1, scale=0.2))


@pytest.mark.parametrize("S", [32, 80])
def test_time_and_channel_mix_match_jax(rwkv, S):
    """JAX's chunked form is finite at these lengths (chunk 16 divides
    them): the port's time_mix, from a random shift and state, gives JAX's
    output, shift and state; channel_mix its output and shift."""
    pj, pt = rwkv
    x = _x((2, S, D_RWKV), seed=S)
    shift, wkv = _states(2, D_RWKV, RWKV_SMOKE["head_dim"], seed=S + 1)
    oj, sj, hj = jr6.time_mix(pj, jnp.asarray(x), JRWKVConfig(**RWKV_SMOKE),
                              jnp.asarray(shift), jnp.asarray(wkv))
    ot, st, ht = tr6.time_mix(pt, _t(x), RWKVConfig(**RWKV_SMOKE), _t(shift),
                              _t(wkv))
    assert np.isfinite(np.asarray(oj)).all()
    _close(ot, oj, 1e-4)
    _close(st, sj, 1e-5)
    _close(ht, hj, 1e-4)
    cj, csj = jr6.channel_mix(pj, jnp.asarray(x), jnp.asarray(shift))
    ct, cst = tr6.channel_mix(pt, _t(x), _t(shift))
    _close(ct, cj, 1e-5)
    _close(cst, csj, 1e-5)


def test_step_time_mix_matches_jax(rwkv):
    """16 steps from a random state: each output and the state after it."""
    pj, pt = rwkv
    x = _x((2, 16, D_RWKV), seed=7)
    shift, wkv = _states(2, D_RWKV, RWKV_SMOKE["head_dim"], seed=8)
    stj = {"wkv": jnp.asarray(wkv), "tm_shift": jnp.asarray(shift)}
    stt = {"wkv": _t(wkv), "tm_shift": _t(shift)}
    for k, v in tr6.init_rwkv6_state(2, D_RWKV, RWKVConfig(**RWKV_SMOKE),
                                     device="cpu").items():
        want = jr6.init_rwkv6_state(2, D_RWKV, JRWKVConfig(**RWKV_SMOKE))[k]
        assert v.shape == want.shape and not v.any(), k
        assert str(v.dtype) == f"torch.{want.dtype}", k
    for t in range(16):
        oj, stj = jr6.step_time_mix(pj, jnp.asarray(x[:, t:t + 1]),
                                    JRWKVConfig(**RWKV_SMOKE), stj)
        ot, stt = tr6.step_time_mix(pt, _t(x[:, t:t + 1]),
                                    RWKVConfig(**RWKV_SMOKE), stt)
        _close(ot, oj, 1e-5)
        _close(stt["wkv"], stj["wkv"], 1e-5)
        _close(stt["tm_shift"], stj["tm_shift"], 1e-5)


def _jax_stepwise(pj, x, cfg, shift, wkv):
    """JAX's step_time_mix over every token (a lax.scan): the outputs
    (B, S, D) and the final state."""
    def body(st, xt):
        o, st = jr6.step_time_mix(pj, xt[:, None], cfg, st)
        return st, o[:, 0]

    st, ys = jax.lax.scan(body, {"wkv": wkv, "tm_shift": shift},
                          jnp.moveaxis(x, 1, 0))
    return jnp.moveaxis(ys, 0, 1), st


@pytest.mark.parametrize("d_model,head_dim,chunk,S", [
    (D_RWKV, 16, 16, 90), (D_RWKV, 16, 16, 100), (128, 64, 128, 256)])
def test_time_mix_finite_where_jax_chunked_overflows(d_model, head_dim,
                                                     chunk, S):
    """The intended difference (models/rwkv6.py): JAX's chunked form runs
    S = 90 and 100 as one chunk at the SMOKE chunk 16, and chunk 128 at
    S = 256, and overflows (the init's log decay of -1 a step passes e^88
    within a chunk). The port stays finite and equals JAX's stepwise
    recurrence: outputs and final state within 1e-4."""
    pj, pt = _rwkv(d_model, 2 * d_model, head_dim, seed=1, spread=False)
    x = _x((2, S, d_model), seed=S)
    shift, wkv = _states(2, d_model, head_dim, seed=S + 1)
    cfg_j = JRWKVConfig(head_dim=head_dim, chunk_size=chunk)
    oj, _, _ = jax.jit(lambda p, a, s, w: jr6.time_mix(p, a, cfg_j, s, w))(
        pj, jnp.asarray(x), jnp.asarray(shift), jnp.asarray(wkv))
    assert not np.isfinite(np.asarray(oj)).all()
    want, st = jax.jit(lambda p, a, s, w: _jax_stepwise(p, a, cfg_j, s, w))(
        pj, jnp.asarray(x), jnp.asarray(shift), jnp.asarray(wkv))
    ot, _, ht = tr6.time_mix(pt, _t(x), RWKVConfig(head_dim=head_dim,
                                                     chunk_size=chunk),
                             _t(shift), _t(wkv))
    assert torch.isfinite(ot).all() and torch.isfinite(ht).all()
    _close(ot, want, 1e-4)
    _close(ht, st["wkv"], 1e-4)


def test_time_mix_chunking_is_exact_algebra(rwkv):
    """The cap and the tail split change only rounding: 80 tokens in
    chunks of 4, 16 and 32 (two and a 16-token tail), and at a config
    chunk of 48 (capped at 32), agree within 1e-4."""
    _, pt = rwkv
    x = _t(_x((1, 80, D_RWKV), seed=9))
    shift, wkv = (_t(a) for a in _states(1, D_RWKV, 16, seed=10))
    outs = [tr6.time_mix(pt, x, RWKVConfig(head_dim=16, chunk_size=c),
                         shift, wkv) for c in (4, 16, 32, 48)]
    assert tr6.MAX_CHUNK == 32
    for o, _, h in outs[1:]:
        _close(o, outs[0][0].numpy(), 1e-4)
        _close(h, outs[0][2].numpy(), 1e-4)
    assert dataclasses.asdict(RWKVConfig()) == dataclasses.asdict(
        JRWKVConfig())

"""The port's expert-parallel MoE on gloo CPU ranks against the JAX package
on one device.

One group of 4 gloo ranks (tests/torch_mesh_ranks.py) runs every case: 8
experts, top-2, d = 16, expert_d_ff = 32, swiglu (JAX's MoE mesh tests'
layer). The scalar differentiated is Σ out·G + 0.5·aux for a fixed random
G; each case compares the output, the aux loss and the gradients of x and
of every expert leaf within 1e-4 (scaled by max(1, max|g|) for the
gradients).

* The expert-parallel branch on data2×tp2 and tp4, at capacity factor 8.0
  and at 1.0, where tokens drop. The tokens split over the data dim, and
  capacity follows a shard's local token count, so the oracle is JAX's
  single-device ``apply_moe`` on each data shard's tokens on their own,
  aux averaged over the shards: what JAX's sharded branch computes, drops
  included.
* Weight-stationary decode (6 tokens, S = 1, fsdp "data" on data2×tp2)
  against JAX's single-device ``apply_moe`` with the flag off, at both
  capacity factors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLPConfig as JMLPConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe

from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as tmoe

import torch_mesh_ranks

TOL = 1e-4
AUX_WEIGHT = 0.5
CAPACITY_FACTORS = (8.0, 1.0)
MOE = dict(num_experts=8, top_k=2, expert_d_ff=32,
           weight_stationary_decode=False, capacity_floor_one=True)
DATA_SHARDS = {"data2xtp2": 2, "tp4": 1}


def _oracle(params, x, g, cfg, shards):
    """JAX single-device apply_moe on each of `shards` token shards, aux
    averaged: (out, aux, grads of x and of every leaf)."""
    mlp = JMLPConfig(activation="swiglu")

    def total(p, x_):
        B, S, D = x_.shape
        xt = x_.reshape(B * S, D)
        n = B * S // shards
        outs, auxes = [], []
        for i in range(shards):
            o, a = jmoe.apply_moe(p, xt[i * n:(i + 1) * n].reshape(1, n, D),
                                  cfg, mlp, None)
            outs.append(o.reshape(n, D))
            auxes.append(a)
        out = jnp.concatenate(outs).reshape(B, S, D)
        aux = sum(auxes) / shards
        return (out * g).sum() + AUX_WEIGHT * aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True))(params, x)
    return {"out": np.asarray(out), "aux": float(aux),
            "grads": {"x": np.asarray(gx),
                      **{k: np.asarray(v) for k, v in gp.items()}}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    p = jmoe.init_moe(jax.random.PRNGKey(0), 16, JMoEConfig(**MOE),
                      JMLPConfig(activation="swiglu"), jnp.float32)
    params = {k: np.asarray(v) for k, v in p.items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16, 16)).astype(np.float32)
    g = rng.standard_normal((4, 16, 16)).astype(np.float32)
    x_dec = rng.standard_normal((6, 1, 16)).astype(np.float32)
    g_dec = rng.standard_normal((6, 1, 16)).astype(np.float32)
    payload = {"params": params, "x": x, "g": g, "x_dec": x_dec,
               "g_dec": g_dec, "moe": MOE, "aux_weight": AUX_WEIGHT,
               "capacity_factors": CAPACITY_FACTORS}
    finish = torch_mesh_ranks.start_ranks(
        tmp_path_factory.mktemp("moe_ranks"), "moe_cases", payload)
    want = {}
    for cf in CAPACITY_FACTORS:
        cfg = JMoEConfig(**{**MOE, "capacity_factor": cf})
        for mesh, shards in DATA_SHARDS.items():
            want[("ep", cf, mesh)] = _oracle(p, jnp.asarray(x),
                                             jnp.asarray(g), cfg, shards)
        want[("ws", cf)] = _oracle(p, jnp.asarray(x_dec), jnp.asarray(g_dec),
                                   cfg, 1)
    got = finish()
    return want, got, params, x, x_dec


def _close(got, want, what):
    np.testing.assert_allclose(got["out"], want["out"], atol=TOL, rtol=0,
                               err_msg=f"{what}: out")
    assert abs(got["aux"] - want["aux"]) < TOL, (what, got["aux"],
                                                 want["aux"])
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, w in want["grads"].items():
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got["grads"][k], w, atol=TOL * scale,
                                   rtol=0, err_msg=f"{what}: d{k}")


def _drops(params, tokens, cf, shards):
    """Dropped (token, choice) pairs over the token shards, by the port's
    single-device router."""
    cfg = MoEConfig(**{**MOE, "capacity_factor": cf})
    router = torch.from_numpy(params["router"].copy())
    xt = torch.from_numpy(tokens.reshape(-1, tokens.shape[-1]))
    n = xt.shape[0] // shards
    return sum(int((~tmoe.route(router, xt[i * n:(i + 1) * n],
                                cfg)["keep"]).sum()) for i in range(shards))


@pytest.mark.parametrize("mesh", list(DATA_SHARDS))
@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_expert_parallel_matches_jax(runs, cf, mesh):
    want, got, params, x, _ = runs
    drops = _drops(params, x, cf, DATA_SHARDS[mesh])
    assert (drops > 0) == (cf == 1.0), drops
    for g in got:
        _close(g[("ep", cf, mesh)], want[("ep", cf, mesh)],
               f"rank {g['rank']} cf={cf} {mesh}")


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_weight_stationary_decode_matches_jax(runs, cf):
    want, got, params, _, x_dec = runs
    assert (_drops(params, x_dec, cf, 1) > 0) == (cf == 1.0)
    for g in got:
        _close(g[("ws", cf)], want[("ws", cf)], f"rank {g['rank']} ws cf={cf}")


def test_width_that_does_not_divide_experts_raises():
    """A model dim of 3 over 8 experts (ctx stand-in: only the widths are
    read before the refusal)."""
    from repro_torch.configs.base import MLPConfig

    @dataclasses.dataclass(frozen=True)
    class Ctx:
        mesh: object = object()
        model_shards: int = 3
        model_axis: str = "model"

    p = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in tmoe.moe_param_shapes(
        16, MoEConfig(**MOE), MLPConfig(), torch.float32).items()}
    with pytest.raises(ValueError, match="does not split over mesh axis"):
        tmoe.apply_moe(p, torch.zeros(1, 4, 16), MoEConfig(**MOE),
                       MLPConfig(), Ctx())

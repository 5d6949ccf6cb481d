"""Parity of the port's MoE layer (``repro_torch/models/moe.py``) with the
JAX package's (``repro/models/moe.py``), and the parameter layout and
initialisation of the two MoE configs.

The same numpy inputs, made from a seed, go through JAX's ``_capacity`` and
``_moe_local`` (run as ``tests/test_moe.py`` runs them, on the CPU) and the
port's ``capacity`` and ``moe_local``, in fp32. Tolerances: capacities, the
chosen experts and the kept (token, expert) pairs exactly equal; out and aux
within 1e-5 absolute; every gradient of out·cot + aux within 1e-5 of the
leaf's largest entry (at least 1). The model-level parity is in
``test_torch_moe_model.py`` and ``test_torch_moe_serving.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import model as jmodel
from repro.models import moe as jmoe

from repro_torch.configs import config_from_dict, get_config, \
    get_smoke_config
from repro_torch.configs.base import MLPConfig, MoEConfig
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer

MOE = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
ACTS = ("swiglu", "squared_relu", "gelu")
# 0.0 and 0.5 drop most choices, 1.25 some, 8.0 none
CAPACITY_FACTORS = (0.0, 0.5, 1.25, 8.0)
E, K, D, FF, T = 8, 2, 16, 24, 48
ZERO_ROW = 5          # an all-zero token: equal logits, ties on every expert


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port while this module runs: its
    SMOKE-sized ops gain nothing from more, and under the test run's
    parallel workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _inputs(act, seed=0):
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return rng.normal(0, std, shape).astype(np.float32)

    w = {"router": normal((D, E), 0.5), "w_in": normal((E, D, FF), 0.3),
         "w_out": normal((E, FF, D), 0.3),
         "w_gate": normal((E, D, FF), 0.3) if act == "swiglu" else None}
    x = normal((T, D), 1.0)
    x[ZERO_ROW] = 0.0
    return w, x


def _cfgs(cf, floor_one=True):
    kw = dict(num_experts=E, top_k=K, expert_d_ff=FF, capacity_factor=cf,
              capacity_floor_one=floor_one)
    return JMoEConfig(**kw), MoEConfig(**kw)


def _jax_routes(w, x, cfg_j):
    """JAX's chosen experts (T, K) and keep mask (T, E), by its own
    top_k and its per-expert cumsum (moe.py:78-97)."""
    probs = jax.nn.softmax(jnp.asarray(x) @ w["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, cfg_j.top_k)
    C = jmoe._capacity(x.shape[0], cfg_j)
    match = (top_i[:, :, None] == jnp.arange(E)).any(1)          # (T, E)
    keep = match & (jnp.cumsum(match, axis=0) - 1 < C)
    return np.asarray(top_i), np.asarray(keep)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("arch", MOE)
def test_config_copies_match_jax(arch):
    """CONFIG and SMOKE are field-for-field copies of JAX's, the MoE knobs
    included (capacity_floor_one, weight_stationary_decode,
    router_jitter), and rebuild from JAX's asdict."""
    for get_t, get_j in ((get_config, jax_config),
                         (get_smoke_config, jax_smoke_config)):
        cfg_t, cfg_j = get_t(arch), get_j(arch)
        assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
        assert config_from_dict(dataclasses.asdict(cfg_j)) == cfg_t
        assert cfg_t.family == "moe" and cfg_t.moe.num_experts > 0


@pytest.mark.parametrize("tokens", [1, 3, 4, 25, 26, 96, 4096])
@pytest.mark.parametrize("cf", [0.0, 0.5, 1.25, 8.0])
@pytest.mark.parametrize("floor_one", [True, False])
def test_capacity_matches_jax(tokens, cf, floor_one):
    for E_, K_ in ((8, 2), (128, 8), (384, 8)):
        kw = dict(num_experts=E_, top_k=K_, capacity_factor=cf,
                  capacity_floor_one=floor_one)
        assert tmoe.capacity(tokens, MoEConfig(**kw)) == \
            jmoe._capacity(tokens, JMoEConfig(**kw))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_moe_local_matches_jax(cf, act):
    """Routes and drops exactly JAX's; out and aux within 1e-5."""
    w, x = _inputs(act)
    cfg_j, cfg_t = _cfgs(cf)
    out_j, aux_j = jmoe._moe_local(w["router"], w["w_in"], w["w_gate"],
                                   w["w_out"], jnp.asarray(x), cfg=cfg_j,
                                   activation=act, e_offset=0)
    out_t, aux_t = tmoe.moe_local(*(_t(w[k]) for k in (
        "router", "w_in", "w_gate", "w_out")), _t(x), cfg=cfg_t,
        activation=act)
    top_j, keep_j = _jax_routes(w, x, cfg_j)
    r = tmoe.route(_t(w["router"]), _t(x), cfg_t)
    assert r["top_i"].tolist() == top_j.tolist()
    keep_t = np.zeros((T, E), bool)
    np.put_along_axis(keep_t, r["top_i"].numpy(), r["keep"].numpy(), 1)
    assert keep_t.tolist() == keep_j.tolist()
    if cf < 8.0:
        assert not keep_t.sum() == T * K          # capacity dropped some
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(aux_t), float(aux_j), atol=1e-5,
                               rtol=0)


def test_equal_logits_route_to_the_lowest_experts():
    """A zero token has equal logits on every expert: like
    jax.lax.top_k, the port picks experts 0..k-1, on every row of a
    batch of such tokens, with capacity enough for all."""
    x = np.zeros((6, D), np.float32)
    w, _ = _inputs("swiglu")
    _, cfg_t = _cfgs(8.0)
    top_j, _ = _jax_routes(w, x, _cfgs(8.0)[0])
    r = tmoe.route(_t(w["router"]), _t(x), cfg_t)
    assert r["top_i"].tolist() == top_j.tolist() == [[0, 1]] * 6
    assert r["keep"].all()


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_moe_local_gradients_match_jax(cf, act):
    """Gradients of sum(out·cot) + aux with respect to x, the router and
    every expert weight, with capacity dropping (0.5) and not (8.0)."""
    w, x = _inputs(act, seed=3)
    cfg_j, cfg_t = _cfgs(cf)
    cot = np.random.default_rng(4).normal(size=(T, D)).astype(np.float32)
    names = [k for k in ("router", "w_in", "w_gate", "w_out")
             if w[k] is not None]

    def f_j(x_, *ws):
        p = dict(zip(names, ws))
        out, aux = jmoe._moe_local(p["router"], p["w_in"], p.get("w_gate"),
                                   p["w_out"], x_, cfg=cfg_j,
                                   activation=act, e_offset=0)
        return jnp.sum(out * cot) + aux

    grads_j = jax.grad(f_j, argnums=tuple(range(len(names) + 1)))(
        jnp.asarray(x), *(jnp.asarray(w[k]) for k in names))
    leaves = [_t(x).requires_grad_(True)] + [
        _t(w[k]).requires_grad_(True) for k in names]
    p = dict(zip(names, leaves[1:]))
    out, aux = tmoe.moe_local(p["router"], p["w_in"], p.get("w_gate"),
                              p["w_out"], leaves[0], cfg=cfg_t,
                              activation=act)
    grads_t = torch.autograd.grad((out * _t(cot)).sum() + aux, leaves)
    for name, gt, gj in zip(["x"] + names, grads_t, grads_j):
        want = np.asarray(gj)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(gt.numpy(), want, atol=1e-5 * scale,
                                   rtol=0, err_msg=name)


class _Sizes(TorchDispatchMode):
    """The element count of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.numels = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(o, torch.Tensor):
                self.numels.append(o.numel())
        return out


def test_apply_moe_builds_no_expert_by_token_tensor():
    """apply_moe over (B, S, D) tokens at 64 experts: no op returns a
    tensor of E·T·D elements or more (JAX's combine is (E, T, D) before
    its sum); two calls are bit-identical."""
    E_, B, S = 64, 4, 16
    cfg = MoEConfig(num_experts=E_, top_k=2, expert_d_ff=FF,
                    capacity_factor=1.25)
    rng = np.random.default_rng(5)
    params = {"router": rng.normal(0, 0.5, (D, E_)),
              "w_in": rng.normal(0, 0.3, (E_, D, FF)),
              "w_gate": rng.normal(0, 0.3, (E_, D, FF)),
              "w_out": rng.normal(0, 0.3, (E_, FF, D))}
    params = {k: torch.from_numpy(v.astype(np.float32))
              for k, v in params.items()}
    x = torch.from_numpy(rng.normal(size=(B, S, D)).astype(np.float32))
    with _Sizes() as sizes:
        out, aux = tmoe.apply_moe(params, x, cfg, MLPConfig(d_ff=FF))
    assert out.shape == (B, S, D) and aux.dtype == torch.float32
    assert max(sizes.numels) < E_ * B * S * D // 4
    again, aux2 = tmoe.apply_moe(params, x, cfg, MLPConfig(d_ff=FF))
    assert torch.equal(out, again) and torch.equal(aux, aux2)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_param_spec_is_jax_layout_with_fp32_router(arch, smoke, dtype):
    """param_spec's keys, shapes and dtypes are those of JAX's init (by
    eval_shape, so the full configs cost nothing): moe/* in place of
    mlp/*, the router fp32 in a bf16 model."""
    cfg_j = (jax_smoke_config if smoke else jax_config)(arch)
    cfg_j = dataclasses.replace(cfg_j, dtype=dtype)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k, cfg_j),
                            jax.random.PRNGKey(0))
    want = {"/".join(str(p.key) for p in path): (tuple(a.shape),
                                                 str(a.dtype))
            for path, a in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    spec = ttransformer.param_spec(config_from_dict(dataclasses.asdict(
        cfg_j)))
    assert {k: (tuple(s), str(dt).replace("torch.", ""))
            for k, (s, _, dt) in spec.items()} == want
    assert spec["layers/moe/router"][2] == torch.float32
    assert not any(k.startswith("layers/mlp/") for k in spec)


def _old_parts(w):
    """init_params' draw parts before the expert leaves came: a leaf
    whole, or a 3-D leaf of more than _WHOLE_DRAW_MAX elements one layer
    at a time."""
    by_layer = w.ndim == 3 and w.numel() > ttransformer._WHOLE_DRAW_MAX
    return list(w) if by_layer else [w]


EARLIER = ("qwen3-8b", "qwen3-14b", "nemotron-4-15b", "qwen1.5-110b",
           "internvl2-2b", "musicgen-large", "linformer-paper")


@pytest.mark.parametrize("arch", EARLIER)
def test_init_params_draw_rule_keeps_earlier_weights(arch):
    """Every drawn leaf of each earlier full config (on the meta device:
    no memory) is split into exactly the parts of the rule before the
    expert leaves, so the same seed draws the same numbers in the same
    order: the stacked MLP leaves of qwen3-14b, nemotron-4-15b and
    qwen1.5-110b still go by layer."""
    cfg = get_config(arch)
    for key, (shape, kind, dt) in ttransformer.param_spec(cfg).items():
        if kind not in ("dense", "embed"):
            continue
        w = torch.empty(shape, dtype=dt, device="meta")
        new, old = ttransformer._draw_parts(w), _old_parts(w)
        assert [p.shape for p in new] == [p.shape for p in old], key
        assert [p.storage_offset() for p in new] == \
            [p.storage_offset() for p in old], key


def test_init_params_keeps_qwen3_8b_weights_at_seed_0():
    """qwen3-8b SMOKE at seed 0: every leaf equals a draw by the earlier
    rule, leaf by leaf from one generator."""
    cfg = get_smoke_config("qwen3-8b")
    got = ttransformer.flatten(ttransformer.init_params(
        cfg, generator=torch.Generator().manual_seed(0),
        device=torch.device("cpu")))
    gen = torch.Generator().manual_seed(0)
    for key, (shape, kind, dt) in ttransformer.param_spec(cfg).items():
        if kind in ("dense", "embed"):
            std = 0.02 if kind == "embed" else shape[-2] ** -0.5
            w = torch.empty(shape, dtype=dt)
            for part in _old_parts(w):
                part.copy_(torch.randn(part.shape, generator=gen).mul_(std))
            assert torch.equal(got[key], w), key


def test_init_params_expert_leaves_by_layer_and_expert(monkeypatch):
    """A 4-D expert leaf over the threshold is drawn layer by layer, and a
    layer still over it expert by expert; the router is fp32 in a bf16
    model; the draw is reproducible from the seed."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-30b-a3b"),
                              dtype="bfloat16")
    L_, E_, d, ff = cfg.num_layers, cfg.moe.num_experts, cfg.d_model, \
        cfg.moe.expert_d_ff
    monkeypatch.setattr(ttransformer, "_WHOLE_DRAW_MAX", E_ * d * ff - 1)
    w = torch.empty((L_, E_, d, ff))
    assert [tuple(p.shape) for p in ttransformer._draw_parts(w)] == \
        [(d, ff)] * (L_ * E_)
    monkeypatch.setattr(ttransformer, "_WHOLE_DRAW_MAX", E_ * d * ff)
    assert len(ttransformer._draw_parts(w)) == L_

    def init():
        return ttransformer.flatten(ttransformer.init_params(
            cfg, generator=torch.Generator().manual_seed(0),
            device=torch.device("cpu")))

    a, b = init(), init()
    assert a["layers/moe/router"].dtype == torch.float32
    assert a["layers/moe/w_in"].dtype == torch.bfloat16
    assert all(torch.equal(a[k], b[k]) for k in a)
    std = float(a["layers/moe/w_in"].float().std())
    assert abs(std - d ** -0.5) < 0.1 * d ** -0.5

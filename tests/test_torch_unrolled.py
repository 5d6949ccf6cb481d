"""Parity of the port's unrolled layer layout (``scan_layers=False``:
``layers_list`` params, one subtree per layer) with the JAX package, on the
CPU in fp32: the paper's non-uniform projected dimension (§4, each layer's
E/F of (n, effective_k(k, k_decay, i, L))), its checkpoints in both
directions, and qwen3-8b served unrolled.

Inputs are made with numpy from a seed; JAX parameters are bridged into the
port. Tolerances: logits 1e-4 absolute; losses 1e-4 relative; gradients
1e-5·max(1, max|g|) per leaf; parameters after a train step 1e-6 absolute;
checkpoints and tokens exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import _unflatten_into
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.data import pipeline as jpipe
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.serving.engine import ServingEngine as JaxEngine
from repro.train import trainer as jtrainer

from repro_torch.checkpoint import bridge
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import config_from_dict
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.projections import effective_k
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw_init
from repro_torch.serving import ServingEngine
from repro_torch.train import make_train_step

LOGITS_ATOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-5
PARAM_ATOL = 1e-6
LAYERS, K, K_DECAY = 4, 16, 0.25
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=1.0)


def _flatten_j(tree):
    """{path: np.ndarray}, keyed as the JAX checkpointer's _flatten."""
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np_tree(tree_t):
    return {k: v.detach().numpy()
            for k, v in ttransformer.flatten(tree_t).items()}


def _encoder_cfgs(sharing, kind="linformer"):
    """linformer-paper SMOKE unrolled with k_decay, as
    tests/test_core_linformer.py's TestNonuniformK builds it."""
    base = jax_smoke_config("linformer-paper")
    cfg_j = dataclasses.replace(
        base, dtype="float32", num_layers=LAYERS, scan_layers=False,
        attention=dataclasses.replace(
            base.attention, kind=kind,
            linformer=dataclasses.replace(base.attention.linformer, k=K,
                                          sharing=sharing,
                                          k_decay=K_DECAY)))
    return cfg_j, config_from_dict(dataclasses.asdict(cfg_j))


def _params_t(cfg_t, params_j, grad=True):
    params = bridge.params_from_flat(_flatten_j(params_j), cfg_t,
                                     device="cpu")
    for p in ttransformer.flatten(params).values():
        p.requires_grad_(grad)
    return params


def _mlm_batch(vocab, step=0, seq=48):
    return jpipe.make_mlm_batch(jpipe.SyntheticCorpus(vocab, seed=0),
                                jpipe.DataState(0, step), batch=2, seq=seq)


def _to_t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("sharing", ["headwise", "kv", "layerwise", "none"])
def test_param_layout_matches_jax(sharing):
    """Keys and shapes equal the JAX init's (its checkpointer's list keys
    layers_list/{i}/...); per-layer E/F shrink by effective_k, a
    layerwise-shared E keeps k."""
    cfg_j, cfg_t = _encoder_cfgs(sharing)
    want = jax.eval_shape(lambda r: jmodel.init_params(r, cfg_j),
                          jax.random.PRNGKey(0))
    spec = ttransformer.param_spec(cfg_t)
    assert {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): tuple(a.shape) for path, a in
            jax.tree_util.tree_flatten_with_path(want)[0]} == \
        {k: tuple(s) for k, (s, *_) in spec.items()}
    ks = [effective_k(K, K_DECAY, i, LAYERS) for i in range(LAYERS)]
    assert ks[0] == K and ks[-1] == 4
    if sharing == "layerwise":
        assert spec["shared/lin/E"][0] == (cfg_t.max_seq_len, K)
    else:
        for i, k in enumerate(ks):
            assert spec[f"layers_list/{i}/attn/lin/E"][0][-1] == k
    params = tmodel.init_params(cfg_t, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in
            ttransformer.flatten(params).items()} == \
        {k: tuple(s) for k, (s, *_) in spec.items()}
    flat = ttransformer.flatten(params)
    assert ttransformer.flatten(ttransformer.nest(flat)).keys() == flat.keys()


@pytest.mark.parametrize("sharing", ["headwise", "kv"])
def test_logits_loss_and_every_gradient_match_jax(sharing):
    cfg_j, cfg_t = _encoder_cfgs(sharing)
    params_j = jmodel.init_params(jax.random.PRNGKey(1), cfg_j)
    batch = _mlm_batch(cfg_j.vocab_size)
    logits_j, _, _ = jax.jit(lambda p, b: jmodel.forward(p, cfg_j, b))(
        params_j, _to_j(batch))
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, cfg_j, b), has_aux=True))(
            params_j, _to_j(batch))
    params_t = _params_t(cfg_t, params_j)
    logits_t, _, _ = tmodel.forward(params_t, cfg_t, _to_t(batch))
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), atol=LOGITS_ATOL, rtol=0)
    loss_t, _ = tmodel.loss_fn(params_t, cfg_t, _to_t(batch))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=LOSS_RTOL)
    leaves = ttransformer.flatten(params_t)
    grads_t = torch.autograd.grad(loss_t, list(leaves.values()))
    gj = _flatten_j(grads_j)
    assert set(gj) == set(leaves)
    for (key, _), g in zip(leaves.items(), grads_t):
        want = gj[key]
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g.numpy(), want, atol=GRAD_TOL * scale,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("kind", ["linformer", "standard"])
def test_train_step_matches_jax(kind):
    """One make_train_step step of the unrolled encoder (non-uniform k, or
    the standard baseline unrolled): loss, grad norm, and every parameter
    after AdamW."""
    cfg_j, cfg_t = _encoder_cfgs("headwise", kind=kind)
    params_j = jmodel.init_params(jax.random.PRNGKey(2), cfg_j)
    batch = _mlm_batch(cfg_j.vocab_size, step=1)
    pj, _, mj = jax.jit(jtrainer.make_train_step(
        cfg_j, JOptimizerConfig(**OPT)))(
            params_j, jadamw.adamw_init(params_j, JOptimizerConfig(**OPT)),
            _to_j(batch))
    params_t = _params_t(cfg_t, params_j)
    params_t, opt_t, mt = make_train_step(cfg_t, OptimizerConfig(**OPT))(
        params_t, adamw_init(params_t, OptimizerConfig(**OPT)),
        _to_t(batch))
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mt[name]), float(mj[name]),
                                   rtol=LOSS_RTOL, err_msg=name)
    flat_j = _flatten_j(pj)
    for k, v in _np_tree(params_t).items():
        np.testing.assert_allclose(v, flat_j[k], atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)
    # the moments mirror the list layout (decay on ndim >= 2 only is held
    # by the parameter parity above: the norm scales get none, as in JAX)
    assert ttransformer.flatten(opt_t["mu"]).keys() == \
        ttransformer.flatten(params_t).keys()


def test_unrolled_forward_applies_no_remat():
    """As JAX's unrolled loop, the unrolled layout runs its blocks as they
    are under remat "full": the same loss and gradients as remat "none"."""
    _, cfg_t = _encoder_cfgs("headwise")
    params = tmodel.init_params(cfg_t, seed=3, device="cpu")
    leaves = list(ttransformer.flatten(params).values())
    for p in leaves:
        p.requires_grad_(True)
    batch = _to_t(_mlm_batch(cfg_t.vocab_size))
    res = []
    for remat in ("none", "full"):
        loss, _ = tmodel.loss_fn(params, dataclasses.replace(
            cfg_t, remat=remat), batch)
        res.append((loss, torch.autograd.grad(loss, leaves)))
    torch.testing.assert_close(res[0][0], res[1][0], rtol=0, atol=0)
    for a, b in zip(res[0][1], res[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_jax_checkpoint_restores_in_port(tmp_path):
    cfg_j, cfg_t = _encoder_cfgs("headwise")
    params_j = jmodel.init_params(jax.random.PRNGKey(4), cfg_j)
    path = JCheckpointer(str(tmp_path)).save(2, {"params": params_j})
    got = bridge.params_from_flat(bridge.read_params_npz(path), cfg_t,
                                  device="cpu")
    flat_j = _flatten_j(params_j)
    assert set(flat_j) == set(ttransformer.flatten(got))
    for k, v in _np_tree(got).items():
        assert np.array_equal(v, flat_j[k]), k
    tmpl = {"params": _params_t(cfg_t, params_j, grad=False)}
    restored, _ = Checkpointer(str(tmp_path)).restore(2, tmpl)
    for k, v in _np_tree(restored["params"]).items():
        assert np.array_equal(v, flat_j[k]), k


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port's npz (params and AdamW moments after a step) read back by
    the JAX checkpointer's _unflatten_into into JAX's list layout."""
    cfg_j, cfg_t = _encoder_cfgs("kv")
    params_j = jmodel.init_params(jax.random.PRNGKey(5), cfg_j)
    params_t = _params_t(cfg_t, params_j)
    params_t, opt_t, _ = make_train_step(cfg_t, OptimizerConfig(**OPT))(
        params_t, adamw_init(params_t, OptimizerConfig(**OPT)),
        _to_t(_mlm_batch(cfg_t.vocab_size)))
    path = Checkpointer(str(tmp_path)).save(
        1, {"params": params_t, "opt_state": opt_t})
    with np.load(f"{path}/params.npz") as z:
        flat = {k: z[k] for k in z.files}
    back = _unflatten_into(params_j, flat)
    assert isinstance(back["layers_list"], list)
    for k, v in _flatten_j(back).items():
        assert np.array_equal(v, _np_tree(params_t)[k]), k
    tmpl = {"params": params_j,
            "opt_state": jadamw.adamw_init(params_j, JOptimizerConfig())}
    restored, _ = JCheckpointer(str(tmp_path)).restore(1, tmpl)
    for k, v in _flatten_j(restored["opt_state"]["mu"]).items():
        assert np.array_equal(v, _np_tree(opt_t["mu"])[k]), k


# -- qwen3-8b SMOKE unrolled, served -----------------------------------------


MAX_SEQ = 96
DECODE_CHUNK = 4
PROMPT_LENS = [9, 16, 35, 64, 48, 19]
BUDGETS = [12, 19, 9, 17, 14, 11]


@pytest.fixture(scope="module")
def qwen_unrolled():
    cfg_j = dataclasses.replace(jax_smoke_config("qwen3-8b"),
                                dtype="float32", scan_layers=False)
    params_j = jmodel.init_params(jax.random.PRNGKey(6), cfg_j)
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    params_t = bridge.params_from_flat(_flatten_j(params_j), cfg_t,
                                       device="cpu")
    assert "layers_list" in params_t and "layers" not in params_t
    rng = np.random.default_rng(8)
    prompts = [list(map(int, rng.integers(4, cfg_j.vocab_size, n)))
               for n in PROMPT_LENS]
    return cfg_j, params_j, cfg_t, params_t, prompts


@pytest.mark.parametrize("fmt,prefill_chunk", [("dense", 0), ("paged", 32)],
                         ids=["dense_monolithic", "paged_chunked"])
def test_unrolled_serve_matches_jax_engine(qwen_unrolled, fmt,
                                           prefill_chunk):
    cfg_j, params_j, cfg_t, params_t, prompts = qwen_unrolled
    kw = dict(max_seq=MAX_SEQ, decode_chunk=DECODE_CHUNK,
              prefill_chunk=prefill_chunk, cache_format=fmt)
    want = JaxEngine(params_j, cfg_j, cache_dtype=jnp.float32, **kw).serve(
        prompts, BUDGETS, max_batch=3)
    got = ServingEngine(params_t, cfg_t, device="cpu",
                        cache_dtype=torch.float32, **kw).serve(
                            prompts, BUDGETS, max_batch=3)
    assert got == want

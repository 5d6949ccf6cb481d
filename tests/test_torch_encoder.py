"""Parity of the PyTorch port's encoder slice (the paper's exact Linformer
form, MLM) with the JAX package, on the CPU in fp32.

The same numpy inputs (seeded) go through the JAX functions and through the
port. JAX runs as its own tests run it on the CPU: the Pallas kernels
(`linformer_attn`, `seq_projection`) in interpret mode, the model with
``backend="auto"`` (those kernels) and the pure-jnp references of
core/linformer.py; JAX parameters are bridged into the port. The port's
kernel wrappers run their plain twins on CPU tensors; the autograd
Functions' backwards are plain torch on every device.

Tolerances, each for fp32 arithmetic summed in another order: kernels,
projections and attention 1e-5 absolute; gradients 1e-5 of each leaf's
largest entry; logits 1e-4 absolute; losses 1e-4 relative; parameters after
three AdamW steps 1e-6 absolute (each step moves a parameter by up to ~lr =
1e-3; Adam's update is ~sign(g), so the bound is set by gradient entries
near zero); data and checkpoints exact."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.core import linformer as jlin
from repro.core import projections as jproj
from repro.data import pipeline as jpipe
from repro.kernels import common as jcommon
from repro.kernels import linformer_attn as jla
from repro.kernels import ops as jops
from repro.kernels import seq_projection as jsp
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.train import trainer as jtrainer

from repro_torch.checkpoint import bridge
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import config_from_dict, get_config
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core import linformer as tlin
from repro_torch.core import projections as tproj
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import linformer_attn as tla
from repro_torch.kernels import ops as tops
from repro_torch.kernels import seq_projection as tsp
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw_init
from repro_torch.parallel import plan as tplan
from repro_torch.train import make_train_step

ATOL = 1e-5
GRAD_TOL = 1e-5
LOGITS_ATOL = 1e-4
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-6
B, S, DH = 2, 48, 16
SHARINGS = ("none", "headwise", "kv", "layerwise")


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0, err_msg=what)


def _grad_close(got, want, what=""):
    """|got - want| <= GRAD_TOL · max(1, max|want|)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=GRAD_TOL * scale, rtol=0, err_msg=what)


def _flatten_j(tree):
    """{path: np.ndarray}, keyed as the JAX checkpointer's _flatten."""
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np_tree(tree_t):
    return {k: v.detach().numpy()
            for k, v in ttransformer.flatten(tree_t).items()}


# -- kernels 5 and 6: plain twins against the Pallas kernels ----------------


@pytest.mark.parametrize("H,Hkv,K", [(4, 4, 16), (4, 2, 40), (2, 1, 1)],
                         ids=["mha", "gqa2", "k1"])
def test_linformer_attn_plain_matches_pallas(H, Hkv, K):
    """Kernel 5's plain twin (kernel layout, GQA indexed) against the JAX
    Pallas kernel in interpret mode, which takes k̄/v̄ repeated to H
    heads; the CPU wrapper runs the twin and counts no launch."""
    rng = np.random.default_rng(0)
    q, kb, vb = _np(rng, B, H, S, DH), _np(rng, B, Hkv, K, DH), \
        _np(rng, B, Hkv, K, DH)
    sc = DH ** -0.5
    rep = lambda x: jnp.repeat(jnp.asarray(x), H // Hkv, axis=1)  # noqa
    want = jla.linformer_attn(jnp.asarray(q), rep(kb), rep(vb), scale=sc,
                              block_q=16, interpret=True)
    n0 = tla.linformer_attn.launches
    got = tla.linformer_attn(*map(torch.from_numpy, (q, kb, vb)), scale=sc)
    assert tla.linformer_attn.launches == n0
    _close(got, want)
    _close(tla.linformer_attn_plain(*map(torch.from_numpy, (q, kb, vb)),
                                    scale=sc), want)


@pytest.mark.parametrize("max_seq", [S, 128], ids=["S_rows", "E_sliced"])
@pytest.mark.parametrize("K", [16, 1])
def test_seq_projection_plain_matches_pallas(max_seq, K):
    """Kernel 6's plain twin against the JAX Pallas kernel in interpret
    mode, with E stored for max_seq rows and the leading-row view E[:S]
    passed (S < max_seq); the x operand a strided view of model layout."""
    rng = np.random.default_rng(1)
    x = _np(rng, B, S, 4, DH)                           # model layout
    E = _np(rng, max_seq, K) * K ** -0.5
    want = jsp.seq_projection(jnp.moveaxis(jnp.asarray(x), 2, 1),
                              jnp.asarray(E[:S]), block_s=16, interpret=True)
    xt = torch.from_numpy(x).movedim(2, 1)              # (B, H, S, Dh) view
    n0 = tsp.seq_projection.launches
    got = tsp.seq_projection(xt, torch.from_numpy(E)[:S])
    assert tsp.seq_projection.launches == n0
    _close(got, want)
    # the model-layout wrapper against the JAX one
    got_m = tops.fused_seq_projection(torch.from_numpy(x),
                                      torch.from_numpy(E)[:S])
    _close(got_m, jops.fused_seq_projection(jnp.asarray(x),
                                            jnp.asarray(E[:S])))


# -- the autograd Functions against jax.grad --------------------------------


@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)], ids=["mha", "gqa2"])
def test_linformer_attn_fn_grads_match_jax(H, Hkv):
    """LinformerAttnFn (kernel 5 forward, `_lin_bwd` in plain torch, the
    GQA group summed into its kv head) against jax.grad through
    ops.fused_linformer_attention, for a random cotangent."""
    rng = np.random.default_rng(2)
    K = 24
    q, kb, vb = _np(rng, B, S, H, DH), _np(rng, B, K, Hkv, DH), \
        _np(rng, B, K, Hkv, DH)
    w = _np(rng, B, S, H, DH)
    sc = DH ** -0.5

    def jloss(q, kb, vb):
        return jnp.sum(jops.fused_linformer_attention(q, kb, vb, scale=sc)
                       * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, kb, vb)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, kb, vb)]
    out = tops.fused_linformer_attention(*ts, scale=sc)
    _close(out, jops.fused_linformer_attention(
        *map(jnp.asarray, (q, kb, vb)), scale=sc))
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    for name, g, wj in zip(("dq", "dkbar", "dvbar"), got, want):
        _grad_close(g, wj, name)


def test_seq_projection_fn_grads_match_jax():
    """SeqProjectionFn (kernel 6 forward, `_sp_bwd` in plain torch) against
    jax.grad through ops.fused_seq_projection: dx and dE."""
    rng = np.random.default_rng(3)
    K = 16
    x, E = _np(rng, B, S, 4, DH), _np(rng, S, K) * K ** -0.5
    w = _np(rng, B, K, 4, DH)

    def jloss(x, E):
        return jnp.sum(jops.fused_seq_projection(x, E) * w)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(E))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, E)]
    out = tops.fused_seq_projection(*ts)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    for name, g, wj in zip(("dx", "dE"), got, want):
        _grad_close(g, wj, name)


# -- projections, E/F layout --------------------------------------------------


@pytest.mark.parametrize("kind,per_head", [("linear", False),
                                           ("linear", True),
                                           ("conv", False), ("conv", True),
                                           ("pool", False)])
def test_project_kv_matches_jax(kind, per_head):
    """core/linformer.project_kv: linear E stored for 64 rows and sliced to
    S, shared or per head; conv (c, r) weights shared or per head; pool
    weights from pool_weights."""
    rng = np.random.default_rng(4)
    Hkv = 2
    k, v = _np(rng, B, S, Hkv, DH), _np(rng, B, S, Hkv, DH)
    if kind == "linear":
        shape = (Hkv, 64, 12) if per_head else (64, 12)
        E, F = _np(rng, *shape), _np(rng, *shape)
    elif kind == "conv":
        shape = (Hkv, 16, 4) if per_head else (16, 4)
        E, F = _np(rng, *shape), _np(rng, *shape)
    else:
        E = F = tproj.pool_weights(16, 2).numpy()
        np.testing.assert_array_equal(E, np.asarray(jproj.pool_weights(16,
                                                                       2)))
    jk, jv = jlin.project_kv(*map(jnp.asarray, (k, v, E, F)), kind=kind)
    tk, tv = tlin.project_kv(*map(torch.from_numpy, (k, v, E, F)),
                             kind=kind)
    _close(tk, jk)
    _close(tv, jv)


def test_conv_as_linear_and_effective_k_match_jax():
    rng = np.random.default_rng(5)
    W = _np(rng, 16, 4)
    np.testing.assert_array_equal(
        tproj.conv_as_linear(torch.from_numpy(W), 48).numpy(),
        np.asarray(jproj.conv_as_linear(jnp.asarray(W), 48)))
    for k, decay, i, n in ((128, 1.0, 3, 12), (128, 0.5, 0, 12),
                           (128, 0.5, 11, 12), (96, 0.3, 5, 7),
                           (7, 0.1, 6, 7)):
        assert tproj.effective_k(k, decay, i, n) == \
            jproj.effective_k(k, decay, i, n)


@pytest.mark.parametrize("kind", ["linformer", "linformer_causal"])
@pytest.mark.parametrize("sharing", SHARINGS)
def test_ef_shapes_and_counts_match_jax(kind, sharing):
    """E/F leaves (groups, names, shapes, init scale) and the number of
    distinct projection matrices, for each sharing mode and both forms."""
    cfg_j = jax_smoke_config("linformer-paper")
    att_j = dataclasses.replace(
        cfg_j.attention, kind=kind, num_kv_heads=2,
        linformer=dataclasses.replace(cfg_j.attention.linformer,
                                      sharing=sharing))
    att_t = config_from_dict(dataclasses.asdict(
        dataclasses.replace(cfg_j, attention=att_j))).attention
    L, n = 3, cfg_j.max_seq_len
    want = jax.eval_shape(lambda r: jlin.init_linformer_params(
        r, att_j, num_layers=L, max_seq=n), jax.random.PRNGKey(0))
    got = tlin.linformer_param_shapes(att_t, num_layers=L, max_seq=n)
    assert {g: {k: tuple(a.shape) for k, a in leaves.items()}
            for g, leaves in want.items()} == got
    assert tlin.num_projection_matrices(att_t, L) == \
        jlin.num_projection_matrices(att_j, L)
    init = {g: tlin.init_linformer_params(
        torch.Generator().manual_seed(0), leaves, device=torch.device("cpu"))
        for g, leaves in got.items()}
    for leaves in init.values():
        for a in leaves.values():
            assert abs(a.std().item() * a.shape[-1] ** 0.5 - 1.0) < 0.1
    layer = {k: a[1] for k, a in init.get("per_layer", {}).items()} or None
    E, F = tlin.resolve_ef(init, layer)
    if sharing == "layerwise":
        assert E is F is init["shared"]["E"]
    else:
        assert torch.equal(E, init["per_layer"]["E"][1])
        assert torch.equal(F, init["per_layer"].get("F", init[
            "per_layer"]["E"])[1])


def _encoder_cfgs(sharing="layerwise", **kw):
    cfg_j = dataclasses.replace(jax_smoke_config("linformer-paper"),
                                dtype="float32", **kw)
    cfg_j = dataclasses.replace(cfg_j, attention=dataclasses.replace(
        cfg_j.attention, linformer=dataclasses.replace(
            cfg_j.attention.linformer, sharing=sharing)))
    return cfg_j, config_from_dict(dataclasses.asdict(cfg_j))


@pytest.mark.parametrize("sharing", SHARINGS)
def test_param_layout_matches_jax(sharing):
    """The port's parameter spec holds the JAX init's keys and shapes:
    embed/pos, and the E/F leaves under shared/lin or layers/attn/lin."""
    cfg_j, cfg_t = _encoder_cfgs(sharing)
    want = jax.eval_shape(lambda r: jmodel.init_params(r, cfg_j),
                          jax.random.PRNGKey(0))
    spec = ttransformer.param_spec(cfg_t)
    assert {"/".join(p.key for p in path): tuple(a.shape) for path, a in
            jax.tree_util.tree_flatten_with_path(want)[0]} == \
        {k: tuple(s) for k, (s, *_) in spec.items()}
    assert spec["embed/pos"][0] == (cfg_t.max_seq_len, cfg_t.d_model)
    params = tmodel.init_params(cfg_t, seed=0, device="cpu")
    assert abs(params["embed"]["pos"].std().item() - 0.02) < 2e-3


def test_full_config_matches_jax_and_counts_162m_params():
    from repro.configs import get_config as jax_config
    cfg_j = jax_config("linformer-paper")
    cfg_t = get_config("linformer-paper")
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    n = sum(np.prod(s) for s, *_ in ttransformer.param_spec(cfg_t).values())
    assert cfg_t.padded_vocab_size == 50432 and 162e6 < n < 163e6


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("vocab,shard,mask_prob",
                         [(512, 0, 0.15), (50265, 2, 0.3)])
def test_mlm_batches_match_jax_byte_for_byte(vocab, shard, mask_prob):
    js = jpipe.batches(jpipe.SyntheticCorpus(vocab, seed=7),
                       jpipe.DataState(7, 1), batch=3, seq=130,
                       objective="mlm", mask_prob=mask_prob, shard=shard)
    ts = tpipe.batches(tpipe.SyntheticCorpus(vocab, seed=7),
                       tpipe.DataState(7, 1), batch=3, seq=130,
                       objective="mlm", mask_prob=mask_prob, shard=shard)
    for _ in range(3):
        (bj, sj), (bt, st) = next(js), next(ts)
        assert sj.to_dict() == st.to_dict()
        assert sorted(bj) == sorted(bt) == ["labels", "loss_mask", "tokens"]
        for k in bj:
            assert bj[k].dtype == bt[k].dtype
            assert bj[k].tobytes() == bt[k].tobytes()
        assert not bt["loss_mask"][:, 0].any()             # BOS kept
        assert (bt["tokens"][bt["loss_mask"] == 0]
                == bt["labels"][bt["loss_mask"] == 0]).all()
    one = tpipe.make_mlm_batch(tpipe.SyntheticCorpus(vocab, seed=7),
                               tpipe.DataState(7, 4), batch=2, seq=64,
                               shard=shard)
    ref = jpipe.make_mlm_batch(jpipe.SyntheticCorpus(vocab, seed=7),
                               jpipe.DataState(7, 4), batch=2, seq=64,
                               shard=shard)
    assert all(one[k].tobytes() == ref[k].tobytes() for k in ref)


def test_byte_tokenizer_round_trips_like_jax():
    text = "Linformer: O(n) self-attention — ünïcödé ✓"
    tok_t, tok_j = tpipe.ByteTokenizer(), jpipe.ByteTokenizer()
    ids = tok_t.encode(text)
    assert tok_t.vocab_size == tok_j.vocab_size == 260
    assert ids.dtype == np.int32 and ids.min() >= tpipe.VOCAB_RESERVED
    assert ids.tobytes() == tok_j.encode(text).tobytes()
    assert tok_t.decode(ids) == text == tok_j.decode(ids)
    assert tok_t.decode(np.concatenate([[tpipe.BOS], ids, [tpipe.EOS]])) \
        == text


# -- the model: forward, loss, gradients, train steps, checkpoints ------------


@pytest.fixture(scope="module")
def smoke():
    cfg_j, cfg_t = _encoder_cfgs()
    params_j = jmodel.init_params(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, params_j, cfg_t


def _params_t(cfg_t, params_j, grad=True):
    params = bridge.params_from_flat(_flatten_j(params_j), cfg_t,
                                     device="cpu")
    for p in ttransformer.flatten(params).values():
        p.requires_grad_(grad)
    return params


def _mlm_batch(vocab, step=0, seq=32):
    return jpipe.make_mlm_batch(jpipe.SyntheticCorpus(vocab, seed=0),
                                jpipe.DataState(0, step), batch=B, seq=seq)


def _to_t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("sharing", SHARINGS)
def test_forward_loss_and_gradients_match_jax(sharing):
    """The bridged SMOKE encoder in each sharing mode: logits, loss_fn's
    loss and metrics, and every gradient leaf (embed/pos and the E/F
    leaves included) against jax.value_and_grad through the JAX model
    (its kernels in interpret mode), on an MLM batch of S=40 < max_seq."""
    cfg_j, cfg_t = _encoder_cfgs(sharing)
    params_j = jmodel.init_params(jax.random.PRNGKey(1), cfg_j)
    batch = _mlm_batch(cfg_j.vocab_size, seq=40)
    logits_j, _, _ = jax.jit(lambda p, b: jmodel.forward(p, cfg_j, b))(
        params_j, _to_j(batch))
    (loss_j, met_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, cfg_j, b), has_aux=True))(
        params_j, _to_j(batch))
    params_t = _params_t(cfg_t, params_j)
    logits_t, _, _ = tmodel.forward(params_t, cfg_t, _to_t(batch))
    _close(logits_t, logits_j, atol=LOGITS_ATOL, what="logits")
    loss_t, met_t = tmodel.loss_fn(params_t, cfg_t, _to_t(batch))
    for name in ("loss", "tokens", "perplexity"):
        np.testing.assert_allclose(float(met_t[name].detach()),
                                   float(met_j[name]), rtol=LOSS_RTOL,
                                   err_msg=name)
    assert float(met_t["tokens"]) == batch["loss_mask"].sum()
    leaves = ttransformer.flatten(params_t)
    grads_t = torch.autograd.grad(loss_t, list(leaves.values()))
    flat_gj = _flatten_j(grads_j)
    assert set(flat_gj) == set(leaves)
    for (key, _), g in zip(leaves.items(), grads_t):
        _grad_close(g, flat_gj[key], key)
    assert float(grads_t[list(leaves).index("embed/pos")][40:].abs().max()) \
        == 0.0


def test_reference_route_matches_kernel_route(smoke):
    """backend="reference" (core/linformer.py) and the kernel route (the
    plain twins on the CPU) give the same loss and gradients."""
    cfg_j, params_j, cfg_t = smoke
    batch = _to_t(_mlm_batch(cfg_j.vocab_size, seq=32))
    res = {}
    for backend in ("auto", "reference"):
        c = cfg_t.with_attention_backend(backend)
        params = _params_t(c, params_j)
        loss, _ = tmodel.loss_fn(params, c, batch)
        leaves = ttransformer.flatten(params)
        res[backend] = loss, dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
    np.testing.assert_allclose(res["auto"][0].item(),
                               res["reference"][0].item(), rtol=LOSS_RTOL)
    for k, g in res["auto"][1].items():
        _grad_close(g, res["reference"][1][k].numpy(), k)


OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=1.0)


def test_three_train_steps_match_jax(smoke):
    """Three make_train_step steps of the SMOKE encoder from bridged
    weights over the same MLM batches: loss, grad norm and lr within 1e-4
    relative each step; every parameter after the third within 1e-6."""
    cfg_j, params_j, cfg_t = smoke
    step_j = jax.jit(jtrainer.make_train_step(cfg_j, JOptimizerConfig(**OPT)))
    step_t = make_train_step(cfg_t, OptimizerConfig(**OPT))
    opt_j = jadamw.adamw_init(params_j, JOptimizerConfig(**OPT))
    params_t = _params_t(cfg_t, params_j)
    opt_t = adamw_init(params_t, OptimizerConfig(**OPT))
    pj = params_j
    for step in range(3):
        batch = _mlm_batch(cfg_j.vocab_size, step=step)
        pj, opt_j, mj = step_j(pj, opt_j, _to_j(batch))
        params_t, opt_t, mt = step_t(params_t, opt_t, _to_t(batch))
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(mt[name]), float(mj[name]),
                                       rtol=LOSS_RTOL, err_msg=name)
    flat_j = _flatten_j(pj)
    for k, v in _np_tree(params_t).items():
        np.testing.assert_allclose(v, flat_j[k], atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)


def test_checkpoints_cross_both_ways(smoke, tmp_path):
    """A port checkpoint restores in the JAX checkpointer and a JAX one in
    the port, bit for bit: embed/pos, shared/lin/E and every other leaf,
    parameters and AdamW moments."""
    cfg_j, params_j, cfg_t = smoke
    params_t = _params_t(cfg_t, params_j)
    opt_t = adamw_init(params_t, OptimizerConfig(**OPT))
    params_t, opt_t, _ = make_train_step(cfg_t, OptimizerConfig(**OPT))(
        params_t, opt_t, _to_t(_mlm_batch(cfg_t.vocab_size)))
    Checkpointer(str(tmp_path / "t")).save(
        1, {"params": params_t, "opt_state": opt_t})
    tmpl = {"params": params_j,
            "opt_state": jadamw.adamw_init(params_j, JOptimizerConfig())}
    restored, _ = JCheckpointer(str(tmp_path / "t")).restore(1, tmpl)
    for tree_t, tree_j in ((params_t, restored["params"]),
                           (opt_t["nu"], restored["opt_state"]["nu"])):
        flat_j = _flatten_j(tree_j)
        for k, v in _np_tree(tree_t).items():
            assert np.array_equal(v, flat_j[k]), k
    assert {"embed/pos", "shared/lin/E"} <= set(_flatten_j(
        restored["params"]))

    opt_j = jadamw.adamw_init(params_j, JOptimizerConfig())
    path = JCheckpointer(str(tmp_path / "j")).save(
        3, {"params": params_j, "opt_state": opt_j})
    tmpl_t = _params_t(cfg_t, params_j, grad=False)
    back, _ = Checkpointer(str(tmp_path / "j")).restore(
        3, {"params": tmpl_t, "opt_state": adamw_init(tmpl_t,
                                                       OptimizerConfig())})
    flat_j = _flatten_j(params_j)
    for k, v in _np_tree(back["params"]).items():
        assert np.array_equal(v, flat_j[k]), k
    bridged = bridge.params_from_flat(bridge.read_params_npz(path), cfg_t,
                                      device="cpu")
    for k, v in _np_tree(bridged).items():
        assert np.array_equal(v, flat_j[k]), k
    assert os.path.basename(path) == "step_00000003"


# -- what the exact form refuses -----------------------------------------------


@pytest.mark.parametrize("backend", ["auto", "reference"])
def test_sequence_longer_than_E_raises(smoke, backend):
    """A sequence longer than E's rows (the config's max_seq_len) raises a
    ValueError that says so, in the plan (both routes) and in the model's
    forward (the learned positions run out first); the JAX package fails
    there with a shape error."""
    _, _, cfg_t = smoke
    n = cfg_t.max_seq_len
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(_np(rng, 1, n + 8, 4, DH)) for _ in range(3))
    E = torch.from_numpy(_np(rng, n, 16))
    plan = tplan.AttentionPlan(backend=backend)
    with pytest.raises(ValueError, match=f"sequence length {n + 8} exceeds"):
        plan.exact_attention(q, k, v, E, E, projection="linear",
                             scale=DH ** -0.5)
    c = cfg_t.with_attention_backend(backend)
    params = tmodel.init_params(c, seed=0, device="cpu")
    toks = torch.full((1, n + 8), 5)
    with pytest.raises(ValueError, match="exceeds"):
        tmodel.forward(params, c, {"tokens": toks})


def test_k_above_the_exact_bound_and_ragged_grids_raise_as_in_jax():
    rng = np.random.default_rng(7)
    q = _np(rng, 1, 16, 2, DH)
    kb = _np(rng, 1, tcommon.MAX_EXACT_K + 1, 2, DH)
    with pytest.raises(ValueError, match="K ≤ 512"):
        tops.fused_linformer_attention(*map(torch.from_numpy, (q, kb, kb)),
                                       scale=1.0)
    with pytest.raises(ValueError, match="K ≤ 512"):
        jops.fused_linformer_attention(*map(jnp.asarray, (q, kb, kb)),
                                       scale=1.0)
    ok = _np(rng, 1, tcommon.MAX_EXACT_K, 2, DH)
    assert tops.fused_linformer_attention(
        *map(torch.from_numpy, (q, ok, ok)), scale=1.0).shape == q.shape
    # sequences whose largest divisor under the JAX kernels' default tile
    # is below 8: the JAX grids would degrade to 1- or 2-row blocks
    x = _np(rng, 1, 2 * 521, 2, DH)
    for size, pref in ((509, tcommon.DEFAULT_BLOCK_Q), (96, 64), (7, 256),
                       (2 * 521, tcommon.DEFAULT_BLOCK_S)):
        try:
            want = jcommon.divisor_block(size, pref)
        except ValueError:
            with pytest.raises(ValueError, match="no block divisor"):
                tcommon.divisor_block(size, pref)
        else:
            assert tcommon.divisor_block(size, pref) == want
    with pytest.raises(ValueError, match="no block divisor"):
        tops.fused_seq_projection(torch.from_numpy(x),
                                  torch.from_numpy(_np(rng, 2 * 521, 8)))
    with pytest.raises(ValueError, match="no block divisor"):
        tops.fused_linformer_attention(
            torch.from_numpy(_np(rng, 1, 509, 2, DH)),
            *map(torch.from_numpy, (ok[:, :8], ok[:, :8])), scale=1.0)


def test_decode_and_chunk_prefill_reject_the_exact_form(smoke):
    """The exact form has no decode cache: the decode and chunked-prefill
    entry points and the cache spec raise, with the JAX package's words."""
    cfg_j, params_j, cfg_t = smoke
    att_t, att_j = cfg_t.attention, cfg_j.attention
    params_t = _params_t(cfg_t, params_j, grad=False)
    lp = ttransformer.layer_slice(params_t["layers"], 0)["attn"]
    x = torch.zeros(1, 1, cfg_t.d_model)
    t = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="has no decode path") as terr:
        tattn.apply_attention_decode(lp, x, {}, t, att_t,
                                     shared_lin=params_t["shared"]["lin"])
    lp_j = jax.tree.map(lambda a: a[0], params_j["layers"])["attn"]
    with pytest.raises(ValueError, match="has no decode path") as jerr:
        jattn.apply_attention_decode(
            lp_j, jnp.zeros((1, 1, cfg_j.d_model)), {}, jnp.zeros(
                (1,), jnp.int32), att_j, shared_lin=params_j["shared"]["lin"])
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="no chunked-prefill path") as terr:
        tattn.apply_attention_prefill_chunk(
            lp, torch.zeros(1, 16, cfg_t.d_model), {}, t, att_t,
            shared_lin=params_t["shared"]["lin"])
    with pytest.raises(ValueError, match="no chunked-prefill path") as jerr:
        jattn.apply_attention_prefill_chunk(
            lp_j, jnp.zeros((1, 16, cfg_j.d_model)), {},
            jnp.zeros((1,), jnp.int32), att_j,
            shared_lin=params_j["shared"]["lin"])
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="no decode cache"):
        tmodel.init_cache(cfg_t, batch=1, max_seq=64, device="cpu")
    with pytest.raises(ValueError, match="no decode cache"):
        tmodel.forward(params_t, cfg_t, {"tokens": torch.ones(1, 8).long()},
                       return_cache=True)


def test_learned_positions_in_decode_and_chunk_prefill_match_jax():
    """A causal model with learned positions (qwen3-8b SMOKE with
    use_rope=False) decodes and prefills chunks at per-row offsets with
    ``embed/pos`` at the absolute positions, as in the JAX package: logits
    of a prefill, two chunks and four decode steps within 1e-4."""
    cfg_j = dataclasses.replace(jax_smoke_config("qwen3-8b"),
                                dtype="float32")
    cfg_j = dataclasses.replace(cfg_j, attention=dataclasses.replace(
        cfg_j.attention, use_rope=False))
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    params_j = jmodel.init_params(jax.random.PRNGKey(2), cfg_j)
    params_t = _params_t(cfg_t, params_j, grad=False)
    rng = np.random.default_rng(8)
    n, max_seq = 32, 96
    cj = jmodel.init_cache(cfg_j, batch=B, max_seq=max_seq,
                           dtype=jnp.float32)
    ct = tmodel.init_cache(cfg_t, batch=B, max_seq=max_seq,
                           dtype=torch.float32, device="cpu")
    for nv in ([n, 16], [16, n]):                 # unequal per-row offsets
        toks = rng.integers(4, cfg_j.vocab_size, (B, n)).astype(np.int32)
        lj, cj = jmodel.prefill_chunk(params_j, cfg_j,
                                      {"tokens": jnp.asarray(toks)}, cj,
                                      jnp.asarray(nv, jnp.int32))
        with torch.no_grad():
            lt, ct = tmodel.prefill_chunk(
                params_t, cfg_t, torch.from_numpy(toks.astype(np.int64)),
                ct, torch.tensor(nv, dtype=torch.int32))
        _close(lt, lj, atol=LOGITS_ATOL)
    assert ct["lengths"].tolist() == [n + 16, n + 16]
    step_j = jax.jit(lambda p, b, c: jmodel.decode_step(p, cfg_j, b, c))
    for _ in range(4):
        tok = rng.integers(4, cfg_j.vocab_size, (B, 1))
        lj, cj = step_j(params_j, {"tokens": jnp.asarray(tok, jnp.int32)},
                        cj)
        with torch.no_grad():
            lt, ct = tmodel.decode_step(params_t, cfg_t,
                                        torch.from_numpy(tok), ct)
        _close(lt, lj, atol=LOGITS_ATOL)


# -- the launcher ---------------------------------------------------------------


def test_launcher_trains_the_encoder_mlm_on_the_cpu(tmp_path):
    metrics = tlaunch.main(["--arch", "linformer-paper", "--smoke",
                            "--device", "cpu", "--steps", "2", "--seq", "64",
                            "--batch", "2", "--ckpt-dir", str(tmp_path)])
    assert np.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    # MLM: the loss counts the masked positions only
    assert 0 < metrics["tokens"] < 2 * 64
    assert Checkpointer(str(tmp_path / "linformer-paper")).latest_step() == 2
    with pytest.raises(ValueError, match="exceeds"):
        tlaunch.main(["--arch", "linformer-paper", "--smoke", "--device",
                      "cpu", "--steps", "1", "--seq", "256", "--ckpt-every",
                      "0"])

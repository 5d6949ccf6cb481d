"""Parity of the PyTorch port with the JAX package on the two configs behind
stub frontends, in fp32 at SMOKE size with the JAX weights bridged:
internvl2-2b (``family="vlm"``: 8 patch embeddings prepended to the text)
and musicgen-large (``family="audio"``: frame embeddings in place of
tokens, a GELU MLP, no ``embed/tok`` leaf).

JAX runs as its own tests run it on the CPU (``backend="auto"``: the Pallas
kernels in interpret mode); the port runs on the CPU, where its kernel
wrappers use their plain twins. Inputs (tokens and embeddings) come from
numpy with a seed. Tolerances: 1e-4 absolute on logits and cache leaves;
loss 1e-5 relative; every gradient leaf 1e-5 of its largest entry;
parameters after a train step 1e-6 absolute (lr 1e-3)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.train import trainer as jtrainer

from repro_torch.checkpoint import bridge
from repro_torch.configs import config_from_dict, get_smoke_config
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw_init
from repro_torch.serving import ServingEngine
from repro_torch.train import Trainer, make_train_step

FRONTENDS = ("internvl2-2b", "musicgen-large")
ATOL = 1e-4
MAX_SEQ = 96
S = 48                       # a multiple of the block size c = 16
LEAVES = ("raw_k", "raw_v", "comp_k", "comp_v")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=1.0)


def _flatten_j(tree):
    """{path: np.ndarray}, keyed as the JAX checkpointer's _flatten."""
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", params=FRONTENDS)
def setup(request):
    cfg_j = dataclasses.replace(jax_smoke_config(request.param),
                                dtype="float32")
    params_j = jmodel.init_params(jax.random.PRNGKey(4), cfg_j)
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    params_t = bridge.params_from_flat(_flatten_j(params_j), cfg_t,
                                       device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _batch_np(cfg, B=2, seq=S, seed=0):
    """A training batch of `seq` positions in numpy: frame embeddings
    (audio) or patch embeddings plus text tokens (vlm); labels and mask
    over the text positions."""
    rng = np.random.default_rng(seed)
    D = cfg.d_model
    if cfg.embedding_inputs:
        text = seq
        b = {"embeds": rng.normal(0, 1, (B, seq, D)).astype(np.float32)}
    else:
        text = seq - cfg.frontend_embed_len
        b = {"tokens": rng.integers(4, cfg.vocab_size, (B, text)),
             "frontend_embeds": rng.normal(
                 0, 1, (B, cfg.frontend_embed_len, D)).astype(np.float32)}
    b["labels"] = rng.integers(0, cfg.vocab_size, (B, text))
    b["loss_mask"] = (rng.random((B, text)) < 0.8).astype(np.int32)
    return b


def _to_j(b):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
            for k, v in b.items()}


def _to_t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


def _prefill(setup, batch):
    cfg_j, params_j, cfg_t, params_t = setup
    inputs = {k: v for k, v in batch.items()
              if k in ("tokens", "embeds", "frontend_embeds")}
    out_j = jax.jit(lambda p, b: jmodel.forward(
        p, cfg_j, b, return_cache=True, cache_max_seq=MAX_SEQ,
        cache_dtype=jnp.float32))(params_j, _to_j(inputs))
    with torch.no_grad():
        out_t = tmodel.forward(params_t, cfg_t, _to_t(inputs),
                               return_cache=True, cache_max_seq=MAX_SEQ,
                               cache_dtype=torch.float32)
    return out_j, out_t


def test_param_layout_and_jax_npz(setup, tmp_path):
    """JAX's keys and shapes: musicgen has no embed/tok leaf (and so an
    untied lm_head); a JAX npz loads into the port leaf for leaf."""
    cfg_j, params_j, cfg_t, _ = setup
    flat_j = _flatten_j(params_j)
    spec = ttransformer.param_spec(cfg_t)
    assert {k: tuple(v[0]) for k, v in spec.items()} == \
        {k: v.shape for k, v in flat_j.items()}
    assert ("embed/tok" in spec) == (not cfg_t.embedding_inputs)
    assert "lm_head" in spec
    path = JCheckpointer(str(tmp_path)).save(1, {"params": params_j})
    loaded = bridge.params_from_flat(bridge.read_params_npz(path), cfg_t,
                                     device="cpu")
    for k, v in ttransformer.flatten(loaded).items():
        assert np.array_equal(v.numpy(), flat_j[k]), k
    if cfg_t.embedding_inputs:
        assert "embed" not in loaded


def test_forward_logits_and_cache_build(setup):
    """Logits over the whole stream (patches plus text, or frames) and the
    cache built in the same pass, at S = 48 (three blocks)."""
    (lj, _, cj), (lt, _, ct) = _prefill(setup, _batch_np(setup[2]))
    assert lt.shape == (2, S, setup[2].padded_vocab_size)
    _close(lt, lj)
    for leaf in LEAVES:
        _close(ct[leaf], cj[leaf])
    assert ct["lengths"].tolist() == np.asarray(cj["lengths"]).tolist() \
        == [S, S]


def test_decode_steps_on_tokens_or_embeds(setup):
    """20 decode steps from the S = 48 cache (one fold at t = 63): tokens
    for the vlm, (B, 1, D) embeddings for audio."""
    cfg_j, params_j, cfg_t, params_t = setup
    (_, _, cj), (_, _, ct) = _prefill(setup, _batch_np(cfg_t, seed=1))
    rng = np.random.default_rng(2)
    step_j = jax.jit(lambda p, b, c: jmodel.decode_step(p, cfg_j, b, c))
    for _ in range(20):
        if cfg_t.embedding_inputs:
            e = rng.normal(0, 1, (2, 1, cfg_t.d_model)).astype(np.float32)
            lj, cj = step_j(params_j, {"embeds": jnp.asarray(e)}, cj)
            with torch.no_grad():
                lt, ct = tmodel.decode_step(params_t, cfg_t, None, ct,
                                            embeds=torch.from_numpy(e))
        else:
            tok = rng.integers(4, cfg_t.vocab_size, (2, 1))
            lj, cj = step_j(params_j, {"tokens": jnp.asarray(tok, jnp.int32)},
                            cj)
            with torch.no_grad():
                lt, ct = tmodel.decode_step(params_t, cfg_t,
                                            torch.from_numpy(tok), ct)
        _close(lt, lj)
    for leaf in LEAVES:
        _close(ct[leaf], cj[leaf])
    assert ct["lengths"].tolist() == [S + 20] * 2
    if cfg_t.embedding_inputs:
        with pytest.raises(ValueError, match="embeds"):
            tmodel.decode_step(params_t, cfg_t,
                               torch.zeros((2, 1), dtype=torch.long), ct)


@pytest.mark.parametrize("chunked_ce", [0, 16])
def test_loss_and_grads_with_the_frontend_slice(setup, chunked_ce):
    """loss_fn drops the frontend positions (plain and chunked CE): the
    loss and every gradient leaf as JAX's; musicgen's gradients hold no
    embed/tok."""
    cfg_j, params_j, cfg_t, _ = setup
    cfg_j = dataclasses.replace(cfg_j, chunked_ce=chunked_ce)
    cfg_t = dataclasses.replace(cfg_t, chunked_ce=chunked_ce)
    batch = _batch_np(cfg_t, seed=3)
    (loss_j, met_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, cfg_j, b), has_aux=True))(
            params_j, _to_j(batch))
    params_t = bridge.params_from_flat(_flatten_j(params_j), cfg_t,
                                       device="cpu")
    flat = ttransformer.flatten(params_t)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    loss_t, met_t = tmodel.loss_fn(params_t, cfg_t, _to_t(batch))
    grads_t = torch.autograd.grad(loss_t, list(flat.values()))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    assert float(met_t["tokens"]) == float(met_j["tokens"]) \
        == batch["loss_mask"].sum()
    flat_gj = _flatten_j(grads_j)
    assert set(flat) == set(flat_gj)
    assert ("embed/tok" in flat) == (not cfg_t.embedding_inputs)
    for (k, _), g in zip(flat.items(), grads_t):
        want = flat_gj[k]
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5 * scale,
                                   rtol=0, err_msg=k)


def test_one_train_step_matches_jax(setup):
    """make_train_step (microbatches of one row) on a batch with
    embeddings, unchanged: loss, grad norm and every parameter after the
    update."""
    cfg_j, params_j, cfg_t, _ = setup
    batch = _batch_np(cfg_t, seed=4)
    pt = bridge.params_from_flat(_flatten_j(params_j), cfg_t, device="cpu")
    for leaf in ttransformer.flatten(pt).values():
        leaf.requires_grad_(True)
    pt, _, mt = make_train_step(cfg_t, OptimizerConfig(**OPT),
                                microbatch=1)(
        pt, adamw_init(pt, OptimizerConfig(**OPT)), _to_t(batch))
    pj1, _, mj1 = jax.jit(jtrainer.make_train_step(
        cfg_j, JOptimizerConfig(**OPT), microbatch=1))(
        params_j, jadamw.adamw_init(params_j, JOptimizerConfig(**OPT)),
        _to_j(batch))
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mt[name]), float(mj1[name]),
                                   rtol=1e-5, err_msg=name)
    flat_pj = _flatten_j(pj1)
    flat_pt = ttransformer.flatten(pt)
    assert set(flat_pt) == set(flat_pj)
    for k, v in flat_pt.items():
        np.testing.assert_allclose(v.detach().numpy(), flat_pj[k],
                                   atol=1e-6, rtol=0, err_msg=k)


def test_refusals(setup, tmp_path):
    """prefill_chunk refuses frontend inputs in JAX's words; the engine and
    the Trainer refuse the frontend configs before any work."""
    cfg_j, params_j, cfg_t, params_t = setup
    cache_j = jmodel.init_cache(cfg_j, batch=1, max_seq=MAX_SEQ,
                                dtype=jnp.float32)
    with pytest.raises(ValueError) as want:
        jmodel.prefill_chunk(params_j, cfg_j,
                             {"tokens": jnp.zeros((1, 16), jnp.int32)},
                             cache_j, jnp.asarray([16], jnp.int32))
    cache_t = tmodel.init_cache(cfg_t, batch=1, max_seq=MAX_SEQ,
                                dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError) as got:
        tmodel.prefill_chunk(params_t, cfg_t,
                             torch.zeros((1, 16), dtype=torch.long),
                             cache_t, torch.tensor([16]))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="token prompts only"):
        ServingEngine(params_t, cfg_t, max_seq=MAX_SEQ, device="cpu")
    with pytest.raises(ValueError, match="token batches only"):
        Trainer(cfg_t, TrainConfig(checkpoint_every=0,
                                   checkpoint_dir=str(tmp_path)),
                device="cpu")


def test_ssm_and_hybrid_stay_refused():
    """The transformer module refuses the ssm and hybrid families (the
    model API dispatches them to their own modules, which build them), and
    the model API refuses an unknown family, as JAX's ``_impl`` does."""
    cfg = config_from_dict(dataclasses.asdict(
        jax_smoke_config("qwen3-8b")))
    for bad in (dataclasses.replace(cfg, family="ssm"),
                dataclasses.replace(cfg, family="hybrid")):
        with pytest.raises(ValueError, match="not a transformer family"):
            ttransformer.param_spec(bad)
    for arch in ("rwkv6-1.6b", "zamba2-1.2b"):
        assert tmodel.param_spec(get_smoke_config(arch))
    with pytest.raises(ValueError, match="unknown family"):
        tmodel.param_spec(dataclasses.replace(cfg, family="vision"))

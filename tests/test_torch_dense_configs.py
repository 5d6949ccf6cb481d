"""Parity of the PyTorch port with the JAX package on the three dense
configs beyond qwen3-8b, in fp32 at SMOKE size with the JAX weights bridged:
qwen3-14b (qk-norm, GQA 2), nemotron-4-15b (squared-ReLU MLP, no qk-norm)
and qwen1.5-110b (QKV bias). Serving is held in
``test_torch_dense_serving.py`` (dense pool) and ``test_torch_dense_paged.py``
(paged int8 pool), which take their setup and check from here.

JAX runs as its own tests run it on the CPU (``backend="auto"``: the Pallas
kernels in interpret mode); the port runs on the CPU, where its kernel
wrappers use their plain twins. Each config's JAX parameters are made once
per module (a fixture parametrised by config). Tolerances: 1e-4 absolute on
logits and cache leaves; tokens exact; the train step's loss 1e-5 relative,
every gradient leaf 1e-5 of its largest entry, parameters after the step
1e-6 absolute (lr 1e-3)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.data import pipeline as jpipe
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.serving.engine import ServingEngine as JaxEngine
from repro.train import trainer as jtrainer

from repro_torch.checkpoint import bridge
from repro_torch.configs import config_from_dict, get_config, \
    get_smoke_config
from repro_torch.configs.base import OptimizerConfig
from repro_torch.data.pipeline import EOS
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw_init
from repro_torch.serving import ServingEngine
from repro_torch.train import make_train_step

DENSE = ("qwen3-14b", "nemotron-4-15b", "qwen1.5-110b")
FRONTENDS = ("internvl2-2b", "musicgen-large")
ATOL = 1e-4
MAX_SEQ = 96
LEAVES = ("raw_k", "raw_v", "comp_k", "comp_v")
DECODE_CHUNK = 4
# below one block, whole blocks, a chunk multiple, remainders; every budget
# crosses a block boundary while decoding
PROMPT_LENS = [9, 16, 35, 64, 48, 19]
BUDGETS = [12, 19, 9, 17, 14, 16]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=1.0)


def _flatten_j(tree):
    """{path: np.ndarray}, keyed as the JAX checkpointer's _flatten."""
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def dense_setup(arch):
    """(JAX config, JAX params, port config, bridged port params, prompts)
    of one SMOKE config in fp32."""
    cfg_j = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    params_j = jmodel.init_params(jax.random.PRNGKey(2), cfg_j)
    if cfg_j.attention.qkv_bias:
        # JAX inits the biases to zero: give them values so that the
        # parity below exercises them
        rng = np.random.default_rng(9)
        attn = dict(params_j["layers"]["attn"])
        for n in ("bq", "bk", "bv"):
            attn[n] = jnp.asarray(
                rng.normal(0, 0.1, attn[n].shape).astype(np.float32))
        params_j = dict(params_j, layers=dict(params_j["layers"],
                                              attn=attn))
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    params_t = bridge.params_from_flat(_flatten_j(params_j), cfg_t,
                                       device="cpu")
    rng = np.random.default_rng(11)
    prompts = [list(map(int, rng.integers(4, cfg_j.vocab_size, n)))
               for n in PROMPT_LENS]
    return cfg_j, params_j, cfg_t, params_t, prompts


@pytest.fixture(scope="module", params=DENSE)
def setup(request):
    return dense_setup(request.param)


def _tokens(B, S, seed, vocab=512):
    return np.random.default_rng(seed).integers(4, vocab, (B, S))


def _jax_prefill(cfg_j, params_j, toks):
    fn = jax.jit(lambda p, t: jmodel.forward(
        p, cfg_j, {"tokens": t}, return_cache=True, cache_max_seq=MAX_SEQ,
        cache_dtype=jnp.float32))
    return fn(params_j, jnp.asarray(toks, jnp.int32))


def _torch_prefill(cfg_t, params_t, toks):
    with torch.no_grad():
        return tmodel.forward(params_t, cfg_t,
                              {"tokens": torch.from_numpy(toks)},
                              return_cache=True, cache_max_seq=MAX_SEQ,
                              cache_dtype=torch.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("arch", DENSE + FRONTENDS)
def test_config_copies_match_jax(arch):
    """Both configs of each arch are field-for-field copies, rebuild from
    JAX's asdict, and pad the vocabulary the same way (nemotron's 256000
    included)."""
    for get_t, get_j in ((get_config, jax_config),
                         (get_smoke_config, jax_smoke_config)):
        cfg_t, cfg_j = get_t(arch), get_j(arch)
        assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
        assert config_from_dict(dataclasses.asdict(cfg_j)) == cfg_t
        assert cfg_t.padded_vocab_size == cfg_j.padded_vocab_size
        assert cfg_t.attention.q_per_kv == cfg_j.attention.q_per_kv


def test_param_layout_is_jax_checkpoint_layout(setup, tmp_path):
    """param_spec has JAX's keys and shapes (the biases of qwen1.5, no
    q/k norms for nemotron), and a JAX npz loads into the port unchanged."""
    cfg_j, params_j, cfg_t, _, _ = setup
    flat_j = _flatten_j(params_j)
    spec = ttransformer.param_spec(cfg_t)
    assert {k: tuple(v[0]) for k, v in spec.items()} == \
        {k: v.shape for k, v in flat_j.items()}
    assert ("layers/attn/bq" in spec) == cfg_t.attention.qkv_bias
    assert ("layers/attn/q_norm/scale" in spec) == cfg_t.attention.qk_norm
    path = JCheckpointer(str(tmp_path)).save(1, {"params": params_j})
    loaded = bridge.params_from_flat(bridge.read_params_npz(path), cfg_t,
                                     device="cpu")
    for k, v in ttransformer.flatten(loaded).items():
        assert np.array_equal(v.numpy(), flat_j[k]), k


def test_forward_logits_and_prefill_cache(setup):
    cfg_j, params_j, cfg_t, params_t, _ = setup
    toks = _tokens(2, 48, seed=1)
    lj, _, cj = _jax_prefill(cfg_j, params_j, toks)
    lt, _, ct = _torch_prefill(cfg_t, params_t, toks)
    assert lt.shape == (2, 48, cfg_t.padded_vocab_size)
    _close(lt, lj)
    for leaf in LEAVES:
        _close(ct[leaf], cj[leaf])
    assert ct["lengths"].tolist() == np.asarray(cj["lengths"]).tolist()


def test_decode_steps_across_two_folds(setup):
    """24 decode steps from a 32-token prefill, row 1 set back to position
    27: row 0 folds at t = 47, row 1 at t = 31 and 47."""
    cfg_j, params_j, cfg_t, params_t, _ = setup
    toks = _tokens(2, 32, seed=5)
    _, _, cj = _jax_prefill(cfg_j, params_j, toks)
    _, _, ct = _torch_prefill(cfg_t, params_t, toks)
    cj = dict(cj, lengths=jnp.asarray([32, 27], jnp.int32))
    ct["lengths"] = torch.tensor([32, 27], dtype=torch.int32)
    step_j = jax.jit(lambda p, b, c: jmodel.decode_step(p, cfg_j, b, c))
    feed = _tokens(2, 24, seed=6)
    for i in range(24):
        lj, cj = step_j(params_j,
                        {"tokens": jnp.asarray(feed[:, i:i + 1], jnp.int32)},
                        cj)
        with torch.no_grad():
            lt, ct = tmodel.decode_step(params_t, cfg_t,
                                        torch.from_numpy(feed[:, i:i + 1]),
                                        ct)
        _close(lt, lj)
    for leaf in LEAVES:
        _close(ct[leaf], cj[leaf])
    assert ct["lengths"].tolist() == [56, 51]


def test_decode_scan_tokens(setup):
    cfg_j, params_j, cfg_t, params_t, _ = setup
    toks = _tokens(3, 32, seed=7)
    _, _, cj = _jax_prefill(cfg_j, params_j, toks)
    _, _, ct = _torch_prefill(cfg_t, params_t, toks)
    cur = np.asarray([5, 9, EOS])
    fin = np.asarray([False, True, False])
    tj, cur_j, fin_j, bad_j, cj, _ = jax.jit(
        lambda p, cu, f, c, r: jmodel.decode_scan(
            p, cfg_j, cu, f, c, r, n_steps=20, eos_id=EOS))(
        params_j, jnp.asarray(cur, jnp.int32), jnp.asarray(fin), cj,
        jax.random.PRNGKey(0))
    with torch.no_grad():
        tt, cur_t, fin_t, bad_t, ct = tmodel.decode_scan(
            params_t, cfg_t, torch.from_numpy(cur), torch.from_numpy(fin),
            ct, n_steps=20, eos_id=EOS)
    assert tt.tolist() == np.asarray(tj).tolist()
    assert cur_t.tolist() == np.asarray(cur_j).tolist()
    assert fin_t.tolist() == np.asarray(fin_j).tolist()
    assert bad_t.tolist() == np.asarray(bad_j).tolist()
    assert ct["lengths"].tolist() == np.asarray(cj["lengths"]).tolist() \
        == [52, 32, 32]


def serve_matches_jax(setup, cache_format, prefill_chunk):
    """The serve trace through the port's engine and the JAX engine with
    the same settings: tokens identical, the same prefill counts, no
    quarantine, every page free after a paged serve."""
    cfg_j, params_j, cfg_t, params_t, prompts = setup
    kw = dict(max_seq=MAX_SEQ, decode_chunk=DECODE_CHUNK,
              prefill_chunk=prefill_chunk, cache_format=cache_format)
    want, jsched = JaxEngine(params_j, cfg_j, cache_dtype=jnp.float32,
                             **kw).serve(prompts, BUDGETS, max_batch=3,
                                         return_scheduler=True)
    got, sched = ServingEngine(params_t, cfg_t, device="cpu",
                               cache_dtype=torch.float32, **kw).serve(
        prompts, BUDGETS, max_batch=3, return_scheduler=True)
    assert got == want
    assert [len(o) for o in got] == BUDGETS        # no EOS at random init
    assert sched.stats.prefill_forwards == jsched.stats.prefill_forwards
    assert sched.stats.prefill_tokens == jsched.stats.prefill_tokens
    assert sched.stats.quarantines == 0
    if cache_format == "paged":
        assert sched.pool.alloc.free_pages == sched.pool.alloc.usable_pages


def test_one_train_step_matches_jax(setup):
    """loss_fn's value and every gradient leaf (qwen1.5's bq/bk/bv among
    them), then one make_train_step step: loss, grad norm and every
    parameter after the update."""
    cfg_j, params_j, cfg_t, _, _ = setup
    batch = jpipe.make_causal_batch(jpipe.SyntheticCorpus(512, seed=0),
                                    jpipe.DataState(0, 0), batch=2, seq=32)
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    batch_t = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}

    def params_t():
        p = bridge.params_from_flat(_flatten_j(params_j), cfg_t,
                                    device="cpu")
        for leaf in ttransformer.flatten(p).values():
            leaf.requires_grad_(True)
        return p

    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, cfg_j, b), has_aux=True))(
            params_j, batch_j)
    pt = params_t()
    loss_t, _ = tmodel.loss_fn(pt, cfg_t, batch_t)
    flat = ttransformer.flatten(pt)
    grads_t = torch.autograd.grad(loss_t, list(flat.values()))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    flat_gj = _flatten_j(grads_j)
    assert set(flat) == set(flat_gj)
    for (k, _), g in zip(flat.items(), grads_t):
        want = flat_gj[k]
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5 * scale,
                                   rtol=0, err_msg=k)

    pj, _, mj = jax.jit(jtrainer.make_train_step(
        cfg_j, JOptimizerConfig(**OPT)))(
        params_j, jadamw.adamw_init(params_j, JOptimizerConfig(**OPT)),
        batch_j)
    pt = params_t()
    pt, _, mt = make_train_step(cfg_t, OptimizerConfig(**OPT))(
        pt, adamw_init(pt, OptimizerConfig(**OPT)), batch_t)
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mt[name]), float(mj[name]),
                                   rtol=1e-5, err_msg=name)
    flat_pj = _flatten_j(pj)
    for k, v in ttransformer.flatten(pt).items():
        np.testing.assert_allclose(v.detach().numpy(), flat_pj[k],
                                   atol=1e-6, rtol=0, err_msg=k)

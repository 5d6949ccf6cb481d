"""Parity of the PyTorch port with the JAX package on the attention-free
RWKV6 config, rwkv6-1.6b SMOKE (family ssm), fp32, JAX weights bridged:
the parameter layout and npz checkpoints both ways, the forward's logits
and prefill cache leaf by leaf (JAX's keys and dtypes, a scalar length),
decode steps, ``decode_scan``, ``serve()`` through the static bucketed
fallback with JAX's tokens and its refusals, and one train step with
every gradient leaf and the AdamW update. The ``check_*`` functions here
take a family's setup, and ``test_torch_hybrid_model.py`` runs them on
zamba2-1.2b SMOKE too.

JAX runs as its own tests run it on the CPU; the port runs on the CPU.
The prompt lengths divide the SMOKE chunk or are shorter than it, where
JAX's chunked time mix is finite (``test_torch_ssm.py`` holds the lengths
where it is not). Tolerances: 1e-4 absolute on logits and cache leaves;
tokens exact; the train step's loss 1e-5 relative, every gradient leaf
1e-5 of its largest entry, parameters after the step 1e-6 absolute (lr
1e-3)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
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
from repro_torch.data.pipeline import EOS
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw_init
from repro_torch.serving import ServingEngine
from repro_torch.train import make_train_step

from test_torch_dense_configs import _flatten_j

ATOL = 1e-4
MAX_SEQ = 96
DECODE_CHUNK = 4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=1.0)
# the leaves JAX keeps in fp32 whatever the model dtype
FP32_LEAVES = {"ssm": ("layers/rwkv/decay_base", "layers/rwkv/bonus_u"),
               "hybrid": ("trunk/ssm/A_log", "trunk/ssm/D_skip",
                          "trunk/ssm/dt_bias")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port while this module runs: its
    SMOKE-sized ops gain nothing from more, and under the test run's
    parallel workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def family_setup(arch, prefill_len, prompt_lens):
    """A family's SMOKE config in fp32 with remat "full": JAX's config,
    params and jitted prefill and decode step, the port's config and
    bridged params, the prefill length and the serve's prompts."""
    cfg_j = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                                remat="full")
    params_j = jmodel.init_params(jax.random.PRNGKey(2), cfg_j)
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    params_t = bridge.params_from_flat(_flatten_j(params_j), cfg_t,
                                       device="cpu")
    rng = np.random.default_rng(11)
    prompts = [list(map(int, rng.integers(4, cfg_j.vocab_size, n)))
               for n in prompt_lens]
    return dict(
        cfg_j=cfg_j, params_j=params_j, cfg_t=cfg_t, params_t=params_t,
        S=prefill_len, prompts=prompts,
        prefill=jax.jit(lambda p, t: jmodel.forward(
            p, cfg_j, {"tokens": t}, return_cache=True,
            cache_max_seq=MAX_SEQ, cache_dtype=jnp.float32)),
        step=jax.jit(lambda p, b, c: jmodel.decode_step(p, cfg_j, b, c)))


@pytest.fixture(scope="module")
def setup():
    return family_setup("rwkv6-1.6b", 40, (5, 19, 16, 40, 5, 19))


def _tokens(B, S, seed, vocab=512):
    return np.random.default_rng(seed).integers(4, vocab, (B, S))


def _close_caches(ct, cj):
    """The port's cache against JAX's, leaf by leaf: keys, dtypes, values."""
    t = {k: v.numpy() for k, v in ttransformer.flatten(ct).items()}
    j = _flatten_j(cj)
    assert set(t) == set(j)
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_allclose(t[k], j[k], atol=ATOL, rtol=0,
                                   err_msg=k)


def _prefill(s, toks):
    lj, _, cj = s["prefill"](s["params_j"], jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        lt, aux, ct = tmodel.forward(
            s["params_t"], s["cfg_t"], {"tokens": torch.from_numpy(toks)},
            return_cache=True, cache_max_seq=MAX_SEQ,
            cache_dtype=torch.float32)
    assert float(aux) == 0.0
    return (lj, cj), (lt, ct)


def check_param_layout_and_checkpoints(s, tmp_path):
    """param_spec has JAX's keys, shapes and dtypes (the fp32 leaves fp32
    in a bf16 model too); a JAX npz loads in the port, and the port's
    checkpoint restores in JAX, leaf for leaf."""
    cfg_t, params_j = s["cfg_t"], s["params_j"]
    flat_j = _flatten_j(params_j)
    spec = tmodel.param_spec(cfg_t)
    assert {k: tuple(v[0]) for k, v in spec.items()} == \
        {k: v.shape for k, v in flat_j.items()}
    for k, (_, _, dt) in spec.items():
        assert str(dt) == f"torch.{flat_j[k].dtype}", k
    path = JCheckpointer(str(tmp_path / "jax")).save(1, {"params": params_j})
    npz = bridge.read_params_npz(path)
    for k, v in ttransformer.flatten(bridge.params_from_flat(
            npz, cfg_t, device="cpu")).items():
        assert np.array_equal(v.numpy(), flat_j[k]), k
    p16 = ttransformer.flatten(bridge.params_from_flat(
        npz, cfg_t, device="cpu", dtype=torch.bfloat16))
    for k, v in p16.items():
        want = torch.float32 if k in FP32_LEAVES[cfg_t.family] \
            else torch.bfloat16
        assert v.dtype == want, k
    Checkpointer(str(tmp_path / "port")).save(
        3, {"params": s["params_t"]})
    restored, _ = JCheckpointer(str(tmp_path / "port")).restore(
        3, {"params": params_j})
    for k, v in _flatten_j(restored["params"]).items():
        assert np.array_equal(v, flat_j[k]), k
    assert tmodel.init_params(cfg_t, seed=0, device="cpu").keys() == \
        params_j.keys()


def check_forward_and_prefill_cache(s):
    toks = _tokens(2, s["S"], seed=1)
    (lj, cj), (lt, ct) = _prefill(s, toks)
    assert lt.shape == (2, s["S"], s["cfg_t"].padded_vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    _close_caches(ct, cj)
    assert int(ct["length"]) == s["S"] and ct["length"].ndim == 0


def check_decode_steps(s):
    """20 decode steps after the prefill: logits each step, every cache
    leaf after the last, length advanced."""
    toks = _tokens(2, s["S"], seed=5)
    (_, cj), (_, ct) = _prefill(s, toks)
    feed = _tokens(2, 20, seed=6)
    for i in range(20):
        lj, cj = s["step"](s["params_j"],
                           {"tokens": jnp.asarray(feed[:, i:i + 1],
                                                  jnp.int32)}, cj)
        with torch.no_grad():
            lt, ct = tmodel.decode_step(s["params_t"], s["cfg_t"],
                                        torch.from_numpy(feed[:, i:i + 1]),
                                        ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=0)
    _close_caches(ct, cj)
    assert int(ct["length"]) == s["S"] + 20


def check_decode_scan(s):
    """16 scan steps over three rows, one finished from the start and one
    emitting EOS: tokens, next tokens, finished, bad and every cache leaf
    (the scalar length advances for every row, as in JAX)."""
    cfg_j, cfg_t = s["cfg_j"], s["cfg_t"]
    toks = _tokens(3, s["S"], seed=7)
    (_, cj), (_, ct) = _prefill(s, toks)
    cur = np.asarray([5, 9, EOS])
    fin = np.asarray([False, True, False])
    tj, cur_j, fin_j, bad_j, cj, _ = jax.jit(
        lambda p, cu, f, c, r: jmodel.decode_scan(
            p, cfg_j, cu, f, c, r, n_steps=16, eos_id=EOS))(
        s["params_j"], jnp.asarray(cur, jnp.int32), jnp.asarray(fin), cj,
        jax.random.PRNGKey(0))
    with torch.no_grad():
        tt, cur_t, fin_t, bad_t, ct = tmodel.decode_scan(
            s["params_t"], cfg_t, torch.from_numpy(cur),
            torch.from_numpy(fin), ct, n_steps=16, eos_id=EOS)
    assert tt.tolist() == np.asarray(tj).tolist()
    assert cur_t.tolist() == np.asarray(cur_j).tolist()
    assert fin_t.tolist() == np.asarray(fin_j).tolist()
    assert bad_t.tolist() == np.asarray(bad_j).tolist()
    _close_caches(ct, cj)


BUDGETS = [8, 12, 6, 10, 9, 7]


def check_serve_static_fallback(s):
    """serve() falls back to the static bucketed path, as JAX's does: the
    tokens of JAX's engine with the same settings, the callbacks fired
    for every token and request, and the cache bytes of JAX's engine."""
    kw = dict(max_seq=MAX_SEQ, decode_chunk=DECODE_CHUNK)
    jeng = JaxEngine(s["params_j"], s["cfg_j"], cache_dtype=jnp.float32,
                     **kw)
    assert not jeng.supports_continuous_batching
    want = jeng.serve(s["prompts"], BUDGETS, max_batch=2)
    eng = ServingEngine(s["params_t"], s["cfg_t"], device="cpu",
                        cache_dtype=torch.float32, **kw)
    assert not eng.supports_continuous_batching
    streamed, done = {}, {}
    got = eng.serve(s["prompts"], BUDGETS, max_batch=2,
                    on_token=lambda i, t: streamed.setdefault(i, []).append(
                        t),
                    on_complete=lambda i, out: done.__setitem__(i, out))
    assert got == want
    assert got == eng.serve_static(s["prompts"], BUDGETS, max_batch=2)
    assert all(0 < len(o) <= b for o, b in zip(got, BUDGETS))
    assert done == dict(enumerate(got))
    assert streamed == {i: o for i, o in enumerate(got) if o}
    assert eng.cache_bytes(3) == jeng.cache_bytes(3)


def check_fallback_refusals(s):
    """The scheduler's options raise, as in JAX; so do the paged pool and
    chunked admission (the static path never uses them), and the model's
    chunked prefill."""
    eng = ServingEngine(s["params_t"], s["cfg_t"], max_seq=MAX_SEQ,
                        device="cpu", cache_dtype=torch.float32)
    n = len(s["prompts"])
    for kw in (dict(return_scheduler=True), dict(arrival_chunks=[0] * n),
               dict(priorities=[0] * n), dict(deadlines=[None] * n),
               dict(max_queue=4), dict(snapshot_chunks=1),
               dict(fault_injector=object())):
        with pytest.raises(ValueError, match="shared-scalar cache"):
            eng.serve(s["prompts"], 4, max_batch=2, **kw)
    blk = eng._block()
    for kw in (dict(cache_format="paged"), dict(prefill_chunk=blk * 2)):
        with pytest.raises(ValueError):
            ServingEngine(s["params_t"], s["cfg_t"], max_seq=MAX_SEQ,
                          device="cpu", **kw)
    cache = tmodel.init_cache(s["cfg_t"], batch=1, max_seq=MAX_SEQ,
                              dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="no chunked-prefill path"):
        tmodel.prefill_chunk(s["params_t"], s["cfg_t"],
                             torch.zeros((1, blk), dtype=torch.long), cache,
                             torch.tensor([blk]))


def check_train_step(s):
    """Under remat "full": loss_fn's loss, every gradient leaf, then one
    make_train_step step: loss, grad norm and every parameter after
    AdamW."""
    cfg_j, cfg_t, params_j = s["cfg_j"], s["cfg_t"], s["params_j"]
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

    (total_j, _), grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, cfg_j, b), has_aux=True))(
            params_j, batch_j)
    pt = params_t()
    total_t, met_t = tmodel.loss_fn(pt, cfg_t, batch_t)
    flat = ttransformer.flatten(pt)
    grads_t = torch.autograd.grad(total_t, list(flat.values()))
    np.testing.assert_allclose(float(total_t.detach()), float(total_j),
                               rtol=1e-5)
    assert float(met_t["aux_loss"]) == 0.0
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


def test_param_layout_and_checkpoints_both_ways(setup, tmp_path):
    check_param_layout_and_checkpoints(setup, tmp_path)


def test_forward_logits_and_prefill_cache(setup):
    check_forward_and_prefill_cache(setup)


def test_decode_steps(setup):
    check_decode_steps(setup)


def test_decode_scan_tokens(setup):
    check_decode_scan(setup)


def test_serve_falls_back_to_static_with_jax_tokens(setup):
    check_serve_static_fallback(setup)


def test_fallback_refusals(setup):
    check_fallback_refusals(setup)


def test_train_step_matches_jax(setup):
    check_train_step(setup)


def test_forward_and_decode_agree_at_lengths_the_chunk_does_not_divide(
        setup):
    """The port's forward over 37 and 50 tokens (whole SMOKE chunks and a
    tail) against its own decode_step loop over the same tokens, from the
    zero state: logits at every position within 1e-4."""
    cfg_t, params_t = setup["cfg_t"], setup["params_t"]
    for S in (37, 50):
        toks = torch.from_numpy(_tokens(2, S, seed=S))
        with torch.no_grad():
            full = tmodel.forward(params_t, cfg_t, {"tokens": toks})[0]
            cache = tmodel.init_cache(cfg_t, batch=2, max_seq=MAX_SEQ,
                                      dtype=torch.float32, device="cpu")
            for t in range(S):
                lt, cache = tmodel.decode_step(params_t, cfg_t,
                                               toks[:, t:t + 1], cache)
                np.testing.assert_allclose(lt[:, 0].numpy(),
                                           full[:, t].numpy(), atol=ATOL,
                                           rtol=0)

"""Parity of the port's standard softmax baseline (``kind="standard"``: full
attention, the full KV cache) with the JAX package, on the CPU in fp32.

Inputs are made with numpy from a seed and handed to both packages; JAX
parameters are bridged into the port. Tolerances: `standard_attention` and
the full-cache functions 1e-5 absolute in fp32 (bf16: 2^-7·max|out|, one
bf16 step of the output's scale, for rounding the scores and p at the same
points in another summation order); model logits and cache leaves 1e-4;
tokens exact; a train step: loss 1e-4 relative, gradients 1e-5·max(1,
max|g|) per leaf, parameters 1e-6 absolute."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.core import cache as jcache
from repro.data import pipeline as jpipe
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.serving.engine import ServingEngine as JaxEngine
from repro.train import trainer as jtrainer

from repro_torch.checkpoint import bridge
from repro_torch.configs import config_from_dict
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core import cache as tcache
from repro_torch.data.pipeline import EOS
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw_init
from repro_torch.serving import ServingEngine
from repro_torch.train import make_train_step

FN_TOL = 1e-5
ATOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-5
PARAM_TOL = 1e-6
MAX_SEQ = 96
DECODE_CHUNK = 4
PROMPT_LENS = [8, 16, 19, 35, 48, 3, 21, 30]
BUDGETS = [12, 20, 9, 17, 30, 25, 14, 11]


def _flatten_j(tree):
    """{path: np.ndarray}, keyed as the JAX checkpointer's _flatten."""
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _leaf_close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0,
                               err_msg=what)


# -- standard_attention -------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_standard_attention_matches_jax(causal, G, dtype):
    rng = np.random.default_rng(10 + G + 2 * causal)
    B, S, Hkv, Dh = 2, 24, 2, 16
    q, k, v = (_np(rng, B, S, Hkv * G, Dh), _np(rng, B, S, Hkv, Dh),
               _np(rng, B, S, Hkv, Dh))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jattn.standard_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), causal=causal)
        .astype(jnp.float32))
    got = tattn.standard_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal)
    assert got.dtype == tdt and got.shape == (B, S, Hkv * G, Dh)
    tol = FN_TOL if dtype == "float32" else 2.0 ** -7 * np.abs(want).max()
    _close(got, want, tol)


def test_standard_attention_gradients_match_jax():
    """The training path differentiates standard_attention (in place ops
    on the scores included) like jax.grad does."""
    rng = np.random.default_rng(4)
    q, k, v = _np(rng, 2, 16, 4, 8), _np(rng, 2, 16, 2, 8), \
        _np(rng, 2, 16, 2, 8)
    ct = _np(rng, 2, 16, 4, 8)
    gj = jax.grad(lambda a, b, c: jnp.sum(jattn.standard_attention(
        a, b, c, causal=True) * ct), argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tattn.standard_attention(*ts, causal=True)
    gt = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), ts)
    for a, b in zip(gt, gj):
        _close(a, b, FN_TOL)


# -- the full KV cache --------------------------------------------------------


def test_full_cache_spec_matches_jax():
    kw = dict(num_layers=3, batch=2, max_seq=40, num_kv_heads=2,
              head_dim=8)
    want = jcache.full_cache_spec(**kw, dtype=jnp.float32)
    got = tcache.full_cache_spec(**kw, dtype=torch.float32)
    assert {k: tuple(v.shape) for k, v in want.items()} == \
        {k: shape for k, (shape, _) in got.items()}
    cache = tcache.init_full_cache(device=torch.device("cpu"), **kw,
                                   dtype=torch.float32)
    assert cache["lengths"].dtype == torch.int32
    assert all(not v.any() for v in cache.values())


def _full_layer(rng, B, S, Hkv, Dh):
    """A filled layer cache, as numpy and as the two packages' dicts."""
    k, v = _np(rng, B, S, Hkv, Dh), _np(rng, B, S, Hkv, Dh)
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())})


@pytest.mark.parametrize("t", [[0, 5], [17, 39], 12],
                         ids=["start", "last_position", "scalar_t"])
def test_full_decode_attention_matches_jax(t):
    rng = np.random.default_rng(20)
    B, S, H, Hkv, Dh = 2, 40, 4, 2, 8
    lj, lt = _full_layer(rng, B, S, Hkv, Dh)
    q, k, v = _np(rng, B, 1, H, Dh), _np(rng, B, 1, Hkv, Dh), \
        _np(rng, B, 1, Hkv, Dh)
    tj = jnp.asarray(t, jnp.int32)
    oj, cj = jcache.full_decode_attention(*map(jnp.asarray, (q, k, v)), lj,
                                          tj)
    ot, ct = tcache.full_decode_attention(
        *map(torch.from_numpy, (q, k, v)), lt,
        torch.tensor(t, dtype=torch.int32))
    _close(ot, oj, FN_TOL)
    assert ct is lt                                  # updated in place
    for leaf in ("k", "v"):
        _close(ct[leaf], cj[leaf], FN_TOL)


@pytest.mark.parametrize("t0,P", [([0, 9], 8), ([30, 36], 8), ([3, 0], 40)],
                         ids=["offsets", "past_max_seq", "whole_cache"])
def test_full_prefill_chunk_matches_jax(t0, P):
    """Per-row offsets; a chunk that runs past max_seq (the start clamped
    to S - P, as dynamic_update_slice clamps); a chunk as wide as the
    cache."""
    rng = np.random.default_rng(21)
    B, S, H, Hkv, Dh = 2, 40, 4, 2, 8
    lj, lt = _full_layer(rng, B, S, Hkv, Dh)
    q, k, v = _np(rng, B, P, H, Dh), _np(rng, B, P, Hkv, Dh), \
        _np(rng, B, P, Hkv, Dh)
    oj, cj = jcache.full_prefill_chunk(*map(jnp.asarray, (q, k, v)), lj,
                                       jnp.asarray(t0, jnp.int32))
    ot, ct = tcache.full_prefill_chunk(*map(torch.from_numpy, (q, k, v)), lt,
                                       torch.tensor(t0, dtype=torch.int32))
    _close(ot, oj, FN_TOL)
    for leaf in ("k", "v"):
        _close(ct[leaf], cj[leaf], FN_TOL)


def test_padded_chunk_tail_is_overwritten_by_decode():
    """A chunk with n_valid < P writes garbage past the row's length;
    decode overwrites it position by position before its mask reaches it:
    both packages' outputs and caches agree through the sequence."""
    rng = np.random.default_rng(22)
    B, S, H, Hkv, Dh, P = 1, 24, 2, 1, 8, 8
    lj, lt = _full_layer(rng, B, S, Hkv, Dh)
    q, k, v = _np(rng, B, P, H, Dh), _np(rng, B, P, Hkv, Dh), \
        _np(rng, B, P, Hkv, Dh)
    _, lj = jcache.full_prefill_chunk(*map(jnp.asarray, (q, k, v)), lj,
                                      jnp.asarray([0], jnp.int32))
    tcache.full_prefill_chunk(*map(torch.from_numpy, (q, k, v)), lt,
                              torch.tensor([0], dtype=torch.int32))
    for t in range(5, 5 + P):              # 5 real tokens, 3 padded
        qt, kt, vt = _np(rng, B, 1, H, Dh), _np(rng, B, 1, Hkv, Dh), \
            _np(rng, B, 1, Hkv, Dh)
        oj, lj = jcache.full_decode_attention(
            *map(jnp.asarray, (qt, kt, vt)), lj, jnp.asarray([t], jnp.int32))
        ot, lt = tcache.full_decode_attention(
            *map(torch.from_numpy, (qt, kt, vt)), lt,
            torch.tensor([t], dtype=torch.int32))
        _close(ot, oj, FN_TOL)
        _close(lt["k"][:, :t + 1], np.asarray(lj["k"])[:, :t + 1], FN_TOL)


# -- qwen3-8b SMOKE, standard -------------------------------------------------


@pytest.fixture(scope="module")
def qwen():
    cfg_j = dataclasses.replace(jax_smoke_config("qwen3-8b"),
                                dtype="float32").with_attention_kind(
                                    "standard")
    params_j = jmodel.init_params(jax.random.PRNGKey(2), cfg_j)
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    params_t = bridge.params_from_flat(_flatten_j(params_j), cfg_t,
                                       device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(4, 512, (B, S))


def _prefill(cfg_j, params_j, cfg_t, params_t, toks):
    lj, _, cj = jax.jit(lambda p, t: jmodel.forward(
        p, cfg_j, {"tokens": t}, return_cache=True, cache_max_seq=MAX_SEQ,
        cache_dtype=jnp.float32))(params_j, jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        lt, _, ct = tmodel.forward(params_t, cfg_t,
                                   {"tokens": torch.from_numpy(toks)},
                                   return_cache=True, cache_max_seq=MAX_SEQ,
                                   cache_dtype=torch.float32)
    return lj, cj, lt, ct


def test_standard_params_have_no_linformer_leaves(qwen):
    _, params_j, cfg_t, params_t = qwen
    keys = set(ttransformer.flatten(params_t))
    assert keys == set(_flatten_j(params_j))
    assert not any("lin" in k.split("/") for k in keys)


@pytest.mark.parametrize("S", [13, 48])
def test_forward_logits_and_full_cache(qwen, S):
    toks = _tokens(2, S, seed=S)
    lj, cj, lt, ct = _prefill(*qwen, toks)
    _close(lt, lj, ATOL)
    for leaf in ("k", "v"):
        _close(ct[leaf], cj[leaf], ATOL)
    assert ct["lengths"].tolist() == np.asarray(cj["lengths"]).tolist()


def test_forty_decode_steps_at_unequal_positions(qwen):
    cfg_j, params_j, cfg_t, params_t = qwen
    _, cj, _, ct = _prefill(*qwen, _tokens(2, 30, seed=5))
    cj = dict(cj, lengths=jnp.asarray([30, 23], jnp.int32))
    ct["lengths"] = torch.tensor([30, 23], dtype=torch.int32)
    step_j = jax.jit(lambda p, b, c: jmodel.decode_step(p, cfg_j, b, c))
    feed = _tokens(2, 40, seed=6)
    for i in range(40):
        lj, cj = step_j(params_j,
                        {"tokens": jnp.asarray(feed[:, i:i + 1], jnp.int32)},
                        cj)
        with torch.no_grad():
            lt, ct = tmodel.decode_step(params_t, cfg_t,
                                        torch.from_numpy(feed[:, i:i + 1]),
                                        ct)
        _close(lt, lj, ATOL)
    for leaf in ("k", "v"):
        _close(ct[leaf], cj[leaf], ATOL)
    assert ct["lengths"].tolist() == [70, 63]


def test_decode_scan_matches_jax(qwen):
    cfg_j, params_j, cfg_t, params_t = qwen
    _, cj, _, ct = _prefill(*qwen, _tokens(3, 20, seed=7))
    cur = np.asarray([5, 9, EOS])
    fin = np.asarray([False, True, False])
    scan_j = jax.jit(lambda p, cu, f, c, r: jmodel.decode_scan(
        p, cfg_j, cu, f, c, r, n_steps=12, eos_id=EOS))
    cur_j, fin_j = jnp.asarray(cur, jnp.int32), jnp.asarray(fin)
    cur_t, fin_t = torch.from_numpy(cur), torch.from_numpy(fin)
    rng = jax.random.PRNGKey(0)
    for _ in range(2):
        tj, cur_j, fin_j, bad_j, cj, rng = scan_j(params_j, cur_j, fin_j,
                                                  cj, rng)
        with torch.no_grad():
            tt, cur_t, fin_t, bad_t, ct = tmodel.decode_scan(
                params_t, cfg_t, cur_t, fin_t, ct, n_steps=12, eos_id=EOS)
        assert tt.tolist() == np.asarray(tj).tolist()
        assert fin_t.tolist() == np.asarray(fin_j).tolist()
        assert bad_t.tolist() == np.asarray(bad_j).tolist()
        assert ct["lengths"].tolist() == np.asarray(cj["lengths"]).tolist()
        for leaf in ("k", "v"):
            _close(ct[leaf], cj[leaf], ATOL)
    assert ct["lengths"].tolist() == [44, 20, 20]


def test_model_prefill_chunk_matches_jax(qwen):
    """Two P = 8 chunks at per-row offsets, the second padded (n_valid 3
    and 8): last-valid logits and the cache leaves."""
    cfg_j, params_j, cfg_t, params_t = qwen
    cj = jmodel.init_cache(cfg_j, batch=2, max_seq=MAX_SEQ,
                           dtype=jnp.float32)
    ct = tmodel.init_cache(cfg_t, batch=2, max_seq=MAX_SEQ,
                           dtype=torch.float32, device="cpu")
    toks = _tokens(2, 16, seed=8)
    for c, n_valid in ((0, [8, 8]), (1, [3, 8])):
        chunk = toks[:, 8 * c:8 * c + 8]
        lj, cj = jmodel.prefill_chunk(params_j, cfg_j,
                                      {"tokens": jnp.asarray(chunk)}, cj,
                                      jnp.asarray(n_valid, jnp.int32))
        with torch.no_grad():
            lt, ct = tmodel.prefill_chunk(params_t, cfg_t,
                                          torch.from_numpy(chunk), ct,
                                          torch.tensor(n_valid))
        _close(lt, lj, ATOL)
        for leaf in ("k", "v"):
            _close(ct[leaf], cj[leaf], ATOL)
    assert ct["lengths"].tolist() == [11, 16]


# -- serving ------------------------------------------------------------------


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [list(map(int, rng.integers(4, vocab, n))) for n in PROMPT_LENS]


@pytest.mark.parametrize("prefill_chunk", [0, 8], ids=["monolithic",
                                                       "chunked"])
def test_serve_matches_jax_engine(qwen, prefill_chunk):
    """Token-identical to the JAX engine; the standard engine's block is
    one token, so prompts admit whole (one prefill per request monolithic,
    chunks of P with no remainder steps chunked)."""
    cfg_j, params_j, cfg_t, params_t = qwen
    prompts = _prompts(cfg_j.vocab_size)
    kw = dict(max_seq=MAX_SEQ, decode_chunk=DECODE_CHUNK,
              prefill_chunk=prefill_chunk)
    want = JaxEngine(params_j, cfg_j, cache_dtype=jnp.float32, **kw).serve(
        prompts, BUDGETS, max_batch=3)
    eng = ServingEngine(params_t, cfg_t, device="cpu",
                        cache_dtype=torch.float32, **kw)
    got, sched = eng.serve(prompts, BUDGETS, max_batch=3,
                           return_scheduler=True)
    assert got == want
    assert [len(o) for o in got] == BUDGETS
    assert eng._block() == 1
    if prefill_chunk:
        # ceil(len / P) chunk rounds per prompt at most, never a remainder
        assert sched.stats.prefill_tokens == sum(PROMPT_LENS)
    else:
        assert sched.stats.prefill_forwards == len(prompts)
    assert eng.cache_bytes(3) == JaxEngine(
        params_j, cfg_j, cache_dtype=jnp.float32, **kw).cache_bytes(3)


def test_standard_engine_on_linformer_params_matches_jax():
    """examples/serve_batched.py: a standard engine built from a
    linformer_causal config's params serves with E/F present and unused."""
    cfg_j = dataclasses.replace(jax_smoke_config("qwen3-8b"),
                                dtype="float32")
    params_j = jmodel.init_params(jax.random.PRNGKey(3), cfg_j)
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    params_t = bridge.params_from_flat(_flatten_j(params_j), cfg_t,
                                       device="cpu")
    assert "shared" in params_t or any(
        "lin" in k.split("/") for k in ttransformer.flatten(params_t))
    prompts = _prompts(cfg_j.vocab_size)[:5]
    want = JaxEngine(params_j, cfg_j.with_attention_kind("standard"),
                     max_seq=MAX_SEQ, cache_dtype=jnp.float32,
                     decode_chunk=DECODE_CHUNK).serve(prompts, BUDGETS[:5],
                                                      max_batch=3)
    got = ServingEngine(params_t, cfg_t.with_attention_kind("standard"),
                        max_seq=MAX_SEQ, device="cpu",
                        cache_dtype=torch.float32,
                        decode_chunk=DECODE_CHUNK).serve(
                            prompts, BUDGETS[:5], max_batch=3)
    assert got == want


def test_paged_pool_refuses_the_standard_kind_as_jax(qwen):
    cfg_j, params_j, cfg_t, params_t = qwen
    with pytest.raises(ValueError) as jerr:
        JaxEngine(params_j, cfg_j, max_seq=MAX_SEQ, cache_format="paged")
    with pytest.raises(ValueError) as terr:
        ServingEngine(params_t, cfg_t, max_seq=MAX_SEQ, device="cpu",
                      cache_format="paged")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        jattn.paged_decode_cache_spec(cfg_j.attention, num_layers=2,
                                      batch=1, max_seq=64)
    with pytest.raises(ValueError) as terr:
        tattn.paged_decode_cache_spec(cfg_t.attention, num_layers=2,
                                      batch=1, max_seq=64)
    assert str(terr.value) == str(jerr.value)


# -- one train step per model ------------------------------------------------


OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=1.0)


def _train_cfgs(arch):
    cfg_j = dataclasses.replace(jax_smoke_config(arch),
                                dtype="float32").with_attention_kind(
                                    "standard")
    return cfg_j, config_from_dict(dataclasses.asdict(cfg_j))


def _batch(cfg, seq):
    corpus = jpipe.SyntheticCorpus(cfg.vocab_size, seed=0)
    make = jpipe.make_mlm_batch if cfg.objective == "mlm" \
        else jpipe.make_causal_batch
    return make(corpus, jpipe.DataState(0, 1), batch=2, seq=seq)


@pytest.mark.parametrize("arch,seq", [("qwen3-8b", 32),
                                      ("linformer-paper", 64)])
def test_train_step_matches_jax(arch, seq):
    """Gradients of loss_fn, then one make_train_step step: the loss, each
    gradient leaf and the parameters after AdamW."""
    cfg_j, cfg_t = _train_cfgs(arch)
    params_j = jmodel.init_params(jax.random.PRNGKey(5), cfg_j)
    batch = _batch(cfg_j, seq)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    bt = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, cfg_j, b), has_aux=True))(params_j,
                                                                  bj)
    params_t = bridge.params_from_flat(_flatten_j(params_j), cfg_t,
                                       device="cpu")
    flat = ttransformer.flatten(params_t)
    for p in flat.values():
        p.requires_grad_(True)
    loss_t, _ = tmodel.loss_fn(params_t, cfg_t, bt)
    grads_t = torch.autograd.grad(loss_t, list(flat.values()))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=LOSS_RTOL)
    gj = _flatten_j(grads_j)
    assert set(gj) == set(flat)
    for k, g in zip(flat, grads_t):
        _leaf_close(g.numpy(), gj[k], GRAD_TOL, k)

    step_j = jax.jit(jtrainer.make_train_step(cfg_j,
                                              JOptimizerConfig(**OPT)))
    pj, _, mj = step_j(params_j, jadamw.adamw_init(
        params_j, JOptimizerConfig(**OPT)), bj)
    step_t = make_train_step(cfg_t, OptimizerConfig(**OPT))
    params_t, _, mt = step_t(params_t, adamw_init(params_t,
                                                  OptimizerConfig(**OPT)), bt)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=LOSS_RTOL)
    pjf = _flatten_j(pj)
    for k, v in ttransformer.flatten(params_t).items():
        np.testing.assert_allclose(v.detach().numpy(), pjf[k],
                                   atol=PARAM_TOL, rtol=0, err_msg=k)


def test_launchers_take_the_attention_override():
    """--attention standard, as the JAX launchers' flag: the serve launcher
    draws JAX's prompt lengths (the standard engine's block is one token)
    and serves them; the train launcher trains the encoder's baseline."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    outs = tserve.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
                        "--attention", "standard", "--requests", "3",
                        "--max-new-tokens", "4"])
    assert len(outs) == 3 and all(0 < len(o) <= 4 for o in outs)
    metrics = ttrain.main(["--arch", "linformer-paper", "--smoke",
                           "--device", "cpu", "--attention", "standard",
                           "--steps", "2", "--ckpt-every", "0"])
    assert np.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0

"""The row-batching contract of MoE serving: qwen3-moe-30b-a3b SMOKE with
its capacity factor cut to 1.0 (fp32, JAX weights bridged), so that a decode
step of the 3-row pool gives each expert C = 1 slot and rows that choose
the same expert compete for it: the later row in the batch drops it. Every
batch the port runs must then hold JAX's rows in JAX's order: the padding
rows that duplicate the last row of an admission batch (and whose state,
not the original's, lands in the pool, as JAX's scatter lands the last of
duplicate indices), the idle rows that ride along in a decode chunk, and
the rows of a snapshot restored after preemption.

Tokens identical to the JAX engine's (fp32): the dense pool monolithic and
chunked, the paged int8 pool chunked and monolithic, preemption under
priorities with the same ShedResults and counters, and the per-token
decode loop."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.engine import ServingEngine as JaxEngine

from repro_torch.models import moe as tmoe
from repro_torch.serving import ServingEngine

from test_torch_dense_configs import BUDGETS, DECODE_CHUNK, MAX_SEQ
from test_torch_moe_model import moe_setup
from test_torch_moe_serving import prompts_for
from test_torch_slo import _requests, serve_both

CAPACITY_FACTOR = 1.0
P = 32
POOLS = {"dense-mono": dict(), "dense-chunked": dict(prefill_chunk=P),
         "paged-chunked": dict(prefill_chunk=P, cache_format="paged"),
         "paged-mono": dict(cache_format="paged")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port while this module runs: its
    SMOKE-sized ops gain nothing from more, and under the test run's
    parallel workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def setup():
    cfg_j, params_j, cfg_t, params_t = moe_setup(
        "qwen3-moe-30b-a3b", capacity_factor=CAPACITY_FACTOR)
    return cfg_j, params_j, cfg_t, params_t, prompts_for(cfg_j.vocab_size)


@pytest.fixture
def drops(monkeypatch):
    """{tokens of a call: (token, expert) choices dropped} of the port's
    routing calls."""
    seen = {}
    route = tmoe.route

    def counting(router, x, cfg):
        r = route(router, x, cfg)
        n = x.shape[0]
        seen[n] = seen.get(n, 0) + int((~r["keep"]).sum())
        return r

    monkeypatch.setattr(tmoe, "route", counting)
    return seen


@pytest.fixture(scope="module")
def engines(setup):
    """{pool: (JAX engine, port engine)}, built once: every case of a pool
    shares the JAX engine's traces."""
    cfg_j, params_j, cfg_t, params_t, _ = setup
    out = {}
    for name, kw in POOLS.items():
        kw = dict(max_seq=MAX_SEQ, decode_chunk=DECODE_CHUNK, **kw)
        out[name] = (JaxEngine(params_j, cfg_j, cache_dtype=jnp.float32,
                               **kw),
                     ServingEngine(params_t, cfg_t, device="cpu",
                                   cache_dtype=torch.float32, **kw))
    return out


@pytest.mark.parametrize("pool", list(POOLS))
def test_serve_matches_jax_when_rows_compete(setup, engines, drops, pool):
    """The serve trace of test_torch_moe_serving.py through both engines
    (max_batch 3): tokens identical, the same prefill counts, no
    quarantine, every page free after a paged serve; decode steps and
    padded admission batches dropped choices."""
    jeng, teng = engines[pool]
    prompts = setup[4]
    want, jsched = jeng.serve(prompts, BUDGETS, max_batch=3,
                              return_scheduler=True)
    got, sched = teng.serve(prompts, BUDGETS, max_batch=3,
                            return_scheduler=True)
    assert got == want
    assert sched.stats.prefill_forwards == jsched.stats.prefill_forwards
    assert sched.stats.prefill_tokens == jsched.stats.prefill_tokens
    assert sched.stats.quarantines == 0
    if teng.paged:
        assert sched.pool.alloc.free_pages == sched.pool.alloc.usable_pages
    assert drops.get(3, 0) > 0                  # decode steps of 3 rows
    if teng.prefill_chunk:
        assert drops.get(3 * P, 0) > 0          # padded admission batches


@pytest.mark.parametrize("pool", ["dense-chunked", "paged-chunked"])
def test_preemption_matches_jax_when_rows_compete(engines, drops, pool):
    """More urgent arrivals displace running requests mid-stream; the
    victims resume from their snapshots into the rows JAX picks."""
    prompts, budgets = _requests(8, seed=21)
    _, sched = serve_both(engines, pool, prompts, budgets, max_batch=2,
                          priorities=[3, 3, 2, 2, 1, 1, 0, 0],
                          arrival_chunks=[0, 0, 1, 1, 2, 2, 3, 3])
    assert sched.stats.preemptions > 0
    assert drops.get(2, 0) > 0


def test_per_token_loop_matches_jax_when_rows_compete(setup, drops):
    """generate_batch_per_token over 3 rows: JAX's tokens, and those of
    the port's device-resident generate_batch."""
    cfg_j, params_j, cfg_t, params_t, _ = setup
    toks = np.random.default_rng(12).integers(4, 512, (3, 24))
    want = JaxEngine(params_j, cfg_j, max_seq=MAX_SEQ,
                     cache_dtype=jnp.float32).generate_batch_per_token(
        toks, 12, jax.random.PRNGKey(0))
    eng = ServingEngine(params_t, cfg_t, max_seq=MAX_SEQ, device="cpu",
                        cache_dtype=torch.float32, decode_chunk=DECODE_CHUNK)
    got = eng.generate_batch_per_token(toks, 12)
    assert np.asarray(got).tolist() == np.asarray(want).tolist()
    assert np.asarray(eng.generate_batch(toks, 12)).tolist() == \
        np.asarray(got).tolist()
    assert drops.get(3, 0) > 0


@pytest.mark.parametrize("cache_format", ["dense", "paged"])
def test_admission_padding_lands_the_last_duplicate(setup, engines,
                                                    cache_format):
    """One row's prompt chunk padded to the 3-row pool by duplicating it:
    the copies route together, the later ones drop where the first one
    keeps, so their states differ. The pool must take the last copy's
    state, as JAX's scatter does: every leaf of both pools equal (paged
    codes within one int8 step: the packages may round a value on either
    side of a half; the TRASH page holds junk and is left out), with the
    first copy's state visibly elsewhere."""
    prompts = setup[4]
    jeng, teng = engines[f"{cache_format}-chunked"]
    jpool, tpool = jeng.init_pool_cache(3), teng.init_pool_cache(3)
    if cache_format == "paged":
        jpool["page_table"] = jpool["page_table"].at[:, 1, :2].set(
            jnp.asarray([3, 5], jnp.int32))
        tpool["page_table"][:, 1, :2] = torch.tensor([3, 5])
    toks = np.asarray([prompts[3][:P]], np.int32)
    nv = np.asarray([P], np.int32)
    jpool, lj = jeng.pool_prefill_chunk(jpool, [1], toks, nv, pad_to=3)
    first = {k: v.clone() for k, v in teng.init_pool_cache(1).items()}
    if cache_format == "paged":
        first["page_table"][:, 0, :2] = torch.tensor([3, 5])
    tpool, lt = teng.pool_prefill_chunk(tpool, [1], toks, nv, pad_to=3)
    teng.pool_prefill_chunk(first, [0], toks, nv, pad_to=1)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    differs = False
    for k, v in tpool.items():
        want = np.asarray(jpool[k]).astype(np.float64)
        got = v.numpy().astype(np.float64)
        if k.startswith("page_"):           # (L, pages, ...), TRASH last
            want, got = want[:, :-1], got[:, :-1]
        tol = 1.0 if v.dtype == torch.int8 else 1e-4
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=k)
        if k in ("comp_v", "page_v"):       # row 1, or its pages 3 and 5
            alone = first[k].numpy().astype(np.float64)
            sel = (slice(None), 0) if k == "comp_v" else \
                (slice(None), [3, 5])
            mine = (slice(None), 1) if k == "comp_v" else sel
            differs = np.abs(alone[sel] - got[mine]).max() > 10 * tol
    assert differs

"""Paged, quantized cache parity: the PyTorch port's quantization, page
gather, paged decode and chunk-prefill steps, quantized-kernel twins, page
allocator and paged serving against the JAX package, on the CPU in fp32,
for int8 and fp8 (e4m3) pages.

The same numpy inputs (seeded) go to both packages; JAX runs its Pallas
kernels in interpret mode and its jnp references. Tolerances: codes and
scales of the quantizer identical on identical inputs; attention outputs
1e-5 absolute (fp32, other summation orders; the JAX suite's FUSED_TOL);
cache scales 1e-6 relative and cache codes at most one quantization step
apart (a fold's einsum sums in another order, which can move a value
across a rounding boundary). Serving must be token-identical, with every
page back in the free list afterwards."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import cache as jcache
from repro.kernels import blockwise_causal_attn as jbca
from repro.kernels import linformer_attn as jla
from repro.models import model as jmodel
from repro.serving import paged as jpaged
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import SHED_PAGES_EXHAUSTED as J_SHED

from repro_torch.checkpoint import bridge
from repro_torch.configs import config_from_dict
from repro_torch.core import cache as tcache
from repro_torch.kernels import blockwise_causal_attn as tbca
from repro_torch.kernels import linformer_attn as tla
from repro_torch.serving import ServingEngine, ShedResult
from repro_torch.serving import paged as tpaged
from repro_torch.serving.scheduler import SHED_PAGES_EXHAUSTED

ATOL = 1e-5
PAGE_DTYPES = ["int8", "fp8"]
B, H, HKV, DH = 2, 4, 2, 16          # GQA: 2 query heads per kv head
C, R, MAXP = 8, 4, 8                 # page = one fold of C tokens -> R slots
M_SLOTS = MAXP * R
NP = B * MAXP + 1                    # + TRASH


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port while this module runs: its
    SMOKE-sized ops gain nothing from more, and under the test run's
    parallel workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _to_torch(x):
    """A JAX or numpy array as a torch tensor; fp8 goes through its bits."""
    a = np.asarray(x)
    if a.dtype.itemsize == 1 and a.dtype != np.int8:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _ordinal(a):
    """Codes as integers whose neighbours are one quantization step apart
    (fp8 e4m3 bits are sign-magnitude)."""
    a = np.asarray(a)
    if a.dtype == np.int8:
        return a.astype(np.int64)
    bits = a.view(np.uint8).astype(np.int64)
    return np.where(bits & 0x80, -(bits & 0x7F), bits)


def _codes(x):
    return x.view(torch.uint8).numpy().view(np.uint8) \
        if x.dtype == torch.float8_e4m3fn else x.numpy()


def _assert_codes_close(got, want):
    assert np.abs(_ordinal(_codes(got)) - _ordinal(want)).max() <= 1


def _close(a_torch, b_jax, atol=ATOL):
    np.testing.assert_allclose(a_torch.detach().numpy(), np.asarray(b_jax),
                               atol=atol, rtol=0)


def _assert_leaf_close(got, want):
    """One cache leaf: codes within a step, scales 1e-6 relative, the rest
    exact."""
    if got.dtype in (torch.int8, torch.float8_e4m3fn):
        _assert_codes_close(got, want)
    elif got.dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# quantization primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("page_dtype", PAGE_DTYPES)
@pytest.mark.parametrize("axes", [(3,), (1, 3), (2, 4)])
def test_quantize_blockwise_identical_to_jax(page_dtype, axes):
    rng = np.random.default_rng(len(axes))
    shape = (3, 5, 4, 2, 16) if 4 in axes else (3, 5, 2, 16)
    x = _np(rng, *shape) * 3
    x[0] = 0.0                                  # a zero block: eps scale
    jdt, jq = jcache.resolve_page_dtype(page_dtype)
    tdt, tq = tcache.resolve_page_dtype(page_dtype)
    assert jq == tq
    want_q, want_s = jcache.quantize_blockwise(jnp.asarray(x), axes,
                                               dtype=jdt, qmax=jq)
    got_q, got_s = tcache.quantize_blockwise(torch.from_numpy(x), axes,
                                             dtype=tdt, qmax=tq)
    np.testing.assert_array_equal(_codes(got_q),
                                  np.asarray(want_q).view(np.uint8)
                                  if page_dtype == "fp8"
                                  else np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if axes == (3,):                       # the per-token (Dh) layout
        np.testing.assert_array_equal(
            tcache.dequantize_blockwise(got_q, got_s).numpy(),
            np.asarray(jcache.dequantize_blockwise(want_q, want_s)))


def test_resolve_page_dtype_as_in_jax():
    for name in ("int8", "fp8"):
        assert tcache.resolve_page_dtype(name)[1] == \
            jcache.resolve_page_dtype(name)[1]
    for pkg in (jcache, tcache):
        with pytest.raises(ValueError, match="int8|fp8"):
            pkg.resolve_page_dtype("int4")


# ---------------------------------------------------------------------------
# the paged layer cache: gather, decode steps, chunk prefill
# ---------------------------------------------------------------------------


def _layer_cache(page_dtype, rng):
    """One layer's paged cache with random arena contents; row b owns pages
    b·MAXP .. (b+1)·MAXP - 1 (the scheduler allocates on demand)."""
    pdt, qmax = jcache.resolve_page_dtype(page_dtype)
    pk, pks = jcache.quantize_blockwise(jnp.asarray(_np(rng, NP, R, HKV, DH)),
                                        (1, 3), dtype=pdt, qmax=qmax)
    pv, pvs = jcache.quantize_blockwise(jnp.asarray(_np(rng, NP, R, HKV, DH)),
                                        (1, 3), dtype=pdt, qmax=qmax)
    return {"raw_k_q": jnp.zeros((B, C, HKV, DH), pdt),
            "raw_v_q": jnp.zeros((B, C, HKV, DH), pdt),
            "raw_k_s": jnp.zeros((B, C, HKV), jnp.float32),
            "raw_v_s": jnp.zeros((B, C, HKV), jnp.float32),
            "page_k": pk, "page_v": pv, "page_k_s": pks, "page_v_s": pvs,
            "page_table": jnp.arange(B * MAXP, dtype=jnp.int32).reshape(
                B, MAXP)}


@pytest.mark.parametrize("page_dtype", PAGE_DTYPES)
def test_paged_gather_matches_jax(page_dtype):
    lc = _layer_cache(page_dtype, np.random.default_rng(1))
    table = np.asarray(lc["page_table"]).copy()
    table[1, 5:] = -1                           # unallocated: page 0's bytes
    for name in ("k", "v"):
        want = jcache.paged_gather(lc[f"page_{name}"], lc[f"page_{name}_s"],
                                   jnp.asarray(table))
        got = tcache.paged_gather(_to_torch(lc[f"page_{name}"]),
                                  _to_torch(lc[f"page_{name}_s"]),
                                  torch.from_numpy(table))
        np.testing.assert_array_equal(_codes(got[0]),
                                      np.asarray(want[0]).view(np.uint8)
                                      if page_dtype == "fp8"
                                      else np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("page_dtype", PAGE_DTYPES)
@pytest.mark.parametrize("plans", [("auto", "fused"),
                                   ("reference", "reference")])
def test_paged_decode_stream_matches_jax(plans, page_dtype):
    """20 decode steps per row at unequal positions (t0 = 0, 5: folds at
    different steps), GQA, through both packages: every step's output and,
    at the end, every cache leaf. The port's "auto" route runs kernel 7's
    plain twin, JAX's "fused" its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(2)
    lc_j = _layer_cache(page_dtype, rng)
    lc_t = {n: _to_torch(x) for n, x in lc_j.items()}
    S = 20
    q, k, v = _np(rng, B, S, H, DH), _np(rng, B, S, HKV, DH), \
        _np(rng, B, S, HKV, DH)
    E, F = _np(rng, C, R) * 0.3, _np(rng, C, R) * 0.3
    t0 = np.asarray([0, 5], np.int32)
    for t in range(S):
        sl = [x[:, t:t + 1] for x in (q, k, v)]
        want, lc_j = jcache.paged_decode_attention(
            *map(jnp.asarray, sl), lc_j, jnp.asarray(E), jnp.asarray(F),
            jnp.asarray(t0 + t), plan=plans[1])
        got, lc_t = tcache.paged_decode_attention(
            *map(torch.from_numpy, sl), lc_t, torch.from_numpy(E),
            torch.from_numpy(F), torch.from_numpy(t0 + t), plan=plans[0])
        _close(got, want)
    for name in lc_j:
        _assert_leaf_close(lc_t[name], lc_j[name])


@pytest.mark.parametrize("page_dtype", PAGE_DTYPES)
@pytest.mark.parametrize("plans", [("auto", "fused"),
                                   ("reference", "reference")])
def test_paged_prefill_chunk_matches_jax(plans, page_dtype):
    """Two 2-block chunks per row at offsets (0, 3c) then (2c, 5c); row 1's
    table lacks pages past block 6, so its folds there go to TRASH:
    outputs, then every cache leaf."""
    rng = np.random.default_rng(3)
    lc_j = _layer_cache(page_dtype, rng)
    table = np.asarray(lc_j["page_table"]).copy()
    table[1, 6:] = -1
    lc_j["page_table"] = jnp.asarray(table)
    lc_t = {n: _to_torch(x) for n, x in lc_j.items()}
    E, F = _np(rng, C, R) * 0.3, _np(rng, C, R) * 0.3
    P = 2 * C
    for t0 in ([0, 3 * C], [2 * C, 5 * C]):
        q, k, v = _np(rng, B, P, H, DH), _np(rng, B, P, HKV, DH), \
            _np(rng, B, P, HKV, DH)
        t0 = np.asarray(t0, np.int32)
        want, lc_j = jcache.paged_prefill_chunk(
            *map(jnp.asarray, (q, k, v)), lc_j, jnp.asarray(E),
            jnp.asarray(F), jnp.asarray(t0), plan=plans[1])
        got, lc_t = tcache.paged_prefill_chunk(
            *map(torch.from_numpy, (q, k, v)), lc_t, torch.from_numpy(E),
            torch.from_numpy(F), torch.from_numpy(t0), plan=plans[0])
        _close(got, want)
    for name in lc_j:
        _assert_leaf_close(lc_t[name], lc_j[name])


# ---------------------------------------------------------------------------
# kernel twins on identical quantized operands
# ---------------------------------------------------------------------------


def _quantized(rng, shape, page_dtype):
    """Kernel-layout codes (B, Hkv, N, Dh) and scales (B, Hkv, N), JAX."""
    pdt, qmax = jcache.resolve_page_dtype(page_dtype)
    return jcache.quantize_blockwise(jnp.asarray(_np(rng, *shape) * 2), (3,),
                                     dtype=pdt, qmax=qmax)


@pytest.mark.parametrize("page_dtype", PAGE_DTYPES)
def test_decode_q_twin_matches_jax_kernel(page_dtype):
    rng = np.random.default_rng(4)
    Bq, G, c, M = 4, 2, 8, 24
    q = _np(rng, Bq, HKV, G, DH)
    ops = [_quantized(rng, (Bq, HKV, n, DH), page_dtype)
           for n in (c, c, M, M)]
    t = np.asarray([0, 7, 13, 95])
    bl = np.where(np.arange(c)[None] <= (t % c)[:, None], 0.0,
                  -1e30).astype(np.float32)
    bg = np.where(np.arange(M)[None] < (t // c * 4)[:, None], 0.0,
                  -1e30).astype(np.float32)
    codes, scales = [x for x, _ in ops], [s for _, s in ops]
    want = jla.decode_attn_q(jnp.asarray(q), *codes, *scales,
                             jnp.asarray(bl), jnp.asarray(bg),
                             scale=DH ** -0.5, interpret=True)
    n0 = tla.decode_attn_q.launches
    got = tla.decode_attn_q(torch.from_numpy(q), *map(_to_torch, codes),
                            *map(_to_torch, scales), torch.from_numpy(bl),
                            torch.from_numpy(bg), scale=DH ** -0.5)
    assert tla.decode_attn_q.launches == n0               # the plain twin
    _close(got, want)


@pytest.mark.parametrize("page_dtype", PAGE_DTYPES)
def test_prefix_q_twin_matches_jax_kernel(page_dtype):
    rng = np.random.default_rng(5)
    Bq, P, M = 3, 2 * C, 40
    q = _np(rng, Bq, H, P, DH)
    k, v = _np(rng, Bq, HKV, P, DH), _np(rng, Bq, HKV, P, DH)
    (ck, cks), (cv, cvs) = (_quantized(rng, (Bq, HKV, M, DH), page_dtype)
                            for _ in range(2))
    sb = np.asarray([0, 2, 9], np.int32)        # row 2 clamped at M
    kw = dict(block_size=C, block_slots=R, scale=DH ** -0.5)
    want = jbca.blockwise_causal_prefix_attn_q(
        *map(jnp.asarray, (q, k, v)), ck, cv, cks, cvs, jnp.asarray(sb),
        interpret=True, **kw)
    got = tbca.blockwise_causal_prefix_attn_q(
        *map(torch.from_numpy, (q, k, v)), *map(_to_torch, (ck, cv, cks, cvs)),
        torch.from_numpy(sb), **kw)
    _close(got, want)


# ---------------------------------------------------------------------------
# the page allocator
# ---------------------------------------------------------------------------


def test_page_allocator_copy_behaves_as_jax():
    """One seeded sequence of allocs and frees on both allocators: the same
    page ids (None when the arena is short), the same scrubbed pages, the
    same counts, and check() holding after every step."""
    rng = np.random.default_rng(6)
    scrubbed = {"jax": [], "torch": []}
    allocs = {"jax": jpaged.PageAllocator(13, scrub=scrubbed["jax"].append),
              "torch": tpaged.PageAllocator(13,
                                            scrub=scrubbed["torch"].append)}
    for _ in range(200):
        row = int(rng.integers(0, 4))
        if rng.random() < 0.6:
            n = int(rng.integers(0, 5))
            got = {k: a.alloc(row, n) for k, a in allocs.items()}
        else:
            got = {k: a.free_row(row) for k, a in allocs.items()}
        assert got["jax"] == got["torch"]
        for a in allocs.values():
            a.check()
        ja, ta = allocs["jax"], allocs["torch"]
        assert (ja.free_pages, ja.used_pages, ja.owned_rows(),
                [ja.pages_of(r) for r in range(4)]) == \
            (ta.free_pages, ta.used_pages, ta.owned_rows(),
             [ta.pages_of(r) for r in range(4)])
    assert scrubbed["jax"] == scrubbed["torch"]
    for p in (jpaged, tpaged):
        assert [p.pages_needed(n, 8) for n in (0, 1, 8, 9, 16)] == \
            [0, 1, 1, 2, 2]
        with pytest.raises(ValueError):
            p.PageAllocator(1)


# ---------------------------------------------------------------------------
# paged serving
# ---------------------------------------------------------------------------

MAX_SEQ = 96
DECODE_CHUNK = 4
# below one block, exact block and chunk multiples, remainders; every
# budget crosses a block boundary while decoding
PROMPT_LENS = [9, 16, 35, 64, 48, 77, 19, 33]
BUDGETS = [12, 19, 9, 17, 14, 11, 16, 10]


@pytest.fixture(scope="module")
def setup():
    cfg_j = dataclasses.replace(jax_smoke_config("qwen3-8b"),
                                dtype="float32")
    params_j = jmodel.init_params(jax.random.PRNGKey(3), cfg_j)
    flat = {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params_j)[0]}
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    params_t = bridge.params_from_flat(flat, cfg_t, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(4, cfg_j.vocab_size, n)))
               for n in PROMPT_LENS]
    return cfg_j, params_j, cfg_t, params_t, prompts


def _engines(setup, **kw):
    cfg_j, params_j, cfg_t, params_t, _ = setup
    kw = dict(max_seq=MAX_SEQ, decode_chunk=DECODE_CHUNK,
              cache_format="paged", **kw)
    return (JaxEngine(params_j, cfg_j, cache_dtype=jnp.float32, **kw),
            ServingEngine(params_t, cfg_t, device="cpu",
                          cache_dtype=torch.float32, **kw))


@pytest.mark.parametrize("page_dtype", PAGE_DTYPES)
@pytest.mark.parametrize("prefill_chunk", [0, 32])
def test_paged_serve_matches_jax_engine(setup, prefill_chunk, page_dtype):
    """Monolithic and chunked admission into the paged pool: tokens
    identical to the JAX paged engine, the same prefill counts, and clean
    page accounting afterwards."""
    *_, prompts = setup
    jeng, teng = _engines(setup, prefill_chunk=prefill_chunk,
                          page_dtype=page_dtype)
    want, jsched = jeng.serve(prompts, BUDGETS, max_batch=3,
                              return_scheduler=True)
    got, sched = teng.serve(prompts, BUDGETS, max_batch=3,
                            return_scheduler=True)
    assert got == want
    assert [len(o) for o in got] == BUDGETS
    assert sched.stats.prefill_forwards == jsched.stats.prefill_forwards
    assert sched.stats.prefill_tokens == jsched.stats.prefill_tokens
    alloc = sched.pool.alloc
    alloc.check()
    assert alloc.free_pages == alloc.usable_pages
    assert sched.pool.pages_allocated == sched.pool.pages_freed \
        == jsched.pool.pages_allocated > 0


def test_cache_bytes_as_in_jax(setup):
    for kw in (dict(), dict(page_dtype="fp8"), dict(arena_pages=20),
               dict(prefill_chunk=32)):
        jeng, teng = _engines(setup, **kw)
        assert teng.cache_bytes(3) == jeng.cache_bytes(3)


def test_pages_exhausted_shed_as_in_jax(setup):
    """A request whose prompt + budget can never fit the arena is shed up
    front with the explicit reason; the others are served."""
    *_, prompts = setup
    jeng, teng = _engines(setup, arena_pages=5)      # 4 usable pages
    args = ([prompts[3], prompts[1]], [20, 6])       # 64 + 20 needs 6
    want = jeng.serve(*args, max_batch=2)
    got = teng.serve(*args, max_batch=2)
    assert isinstance(got[0], ShedResult) and SHED_PAGES_EXHAUSTED == J_SHED
    assert (got[0].rid, got[0].reason, got[0].tick) == \
        (want[0].rid, want[0].reason, want[0].tick)
    assert got[1] == want[1] and len(got[1]) == 6


@pytest.mark.parametrize("prefill_chunk", [0, 32])
def test_page_pressure_preempts_as_in_jax(setup, prefill_chunk):
    """An arena too small for the pool's rows: both schedulers preempt
    under page pressure (snapshot, requeue, restore into fresh pages) with
    the same decisions, so the same tokens and counters, and every page is
    back in the free list afterwards."""
    *_, prompts = setup
    jeng, teng = _engines(setup, prefill_chunk=prefill_chunk,
                          arena_pages=10)
    want, jsched = jeng.serve(prompts, BUDGETS, max_batch=3,
                              return_scheduler=True)
    got, sched = teng.serve(prompts, BUDGETS, max_batch=3,
                            return_scheduler=True)
    assert jsched.stats.page_preemptions > 0
    assert got == want
    assert sched.stats.page_preemptions == jsched.stats.page_preemptions
    assert sched.stats.preemptions == jsched.stats.preemptions
    assert sched.stats.chunks == jsched.stats.chunks
    alloc = sched.pool.alloc
    alloc.check()
    assert alloc.free_pages == alloc.usable_pages
    assert sched.pool.pages_allocated == sched.pool.pages_freed \
        == jsched.pool.pages_allocated

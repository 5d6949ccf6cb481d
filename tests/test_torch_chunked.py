"""Chunked-admission parity: the PyTorch port's prefix-form attention,
chunked cache writes, prefill-at-offset forward and chunked serving against
the JAX package, on the CPU in fp32.

The same numpy inputs (seeded) go through the JAX functions (the Pallas
kernels in interpret mode, and the pure-jnp references) and through the
port (its references, and the plain twins its kernel wrappers run for CPU
tensors). Tolerances: 1e-5 absolute for attention outputs, cache leaves
and logits (fp32, other summation orders); 1e-5 relative for softmax
denominators, which grow with the row length. Serving must be
token-identical."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import cache as jcache
from repro.core import causal as jcausal
from repro.kernels import blockwise_causal_attn as jbca
from repro.kernels import ops as jops
from repro.models import model as jmodel
from repro.serving.engine import ServingEngine as JaxEngine

from repro_torch.checkpoint import bridge
from repro_torch.configs import config_from_dict
from repro_torch.core import cache as tcache
from repro_torch.core import causal as tcausal
from repro_torch.kernels import blockwise_causal_attn as tbca
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.parallel import plan as tplan
from repro_torch.serving import ServingEngine

ATOL = 1e-5
HKV, DH, C, R = 2, 16, 16, 4
P = 2 * C                     # a chunk of two blocks
STARTS = [0, 2, 5]            # per-row start blocks
M_SLOTS = 40                  # > (5 + 2)·4 = 28 needed: a slot buffer with slack


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


def _close(a_torch, b_jax, atol=ATOL):
    np.testing.assert_allclose(a_torch.detach().numpy(), np.asarray(b_jax),
                               atol=atol, rtol=0)


def _prefix_inputs(H, seed):
    """Model-layout q (B, P, H, Dh), k/v (B, P, Hkv, Dh) and a slot buffer
    (B, M, Hkv, Dh), as numpy."""
    rng = np.random.default_rng(seed)
    B = len(STARTS)
    return (_np(rng, B, P, H, DH), _np(rng, B, P, HKV, DH),
            _np(rng, B, P, HKV, DH), _np(rng, B, M_SLOTS, HKV, DH),
            _np(rng, B, M_SLOTS, HKV, DH))


@pytest.mark.parametrize("G", [1, 2])
def test_prefix_reference_matches_jax(G):
    xs = _prefix_inputs(G * HKV, seed=G)
    sb = np.asarray(STARTS, np.int32)
    kw = dict(block_size=C, block_slots=R, scale=DH ** -0.5)
    want = jcausal.blockwise_causal_prefix_attention(
        *map(jnp.asarray, xs), jnp.asarray(sb), **kw)
    got = tcausal.blockwise_causal_prefix_attention(
        *map(torch.from_numpy, xs), torch.from_numpy(sb), **kw)
    _close(got, want)


@pytest.mark.parametrize("residuals", [False, True])
@pytest.mark.parametrize("G", [1, 2])
def test_prefix_kernel_twin_matches_jax(G, residuals):
    """The kernel wrapper on CPU tensors runs kernel 4's plain twin, in both
    forms: against the JAX Pallas kernel (interpret) and the reference."""
    xs = _prefix_inputs(G * HKV, seed=10 + G)
    sb = np.asarray(STARTS, np.int32)
    kl = [np.moveaxis(x, 2, 1) for x in xs]          # kernel layout
    kw = dict(block_size=C, block_slots=R, scale=DH ** -0.5)
    want = jbca.blockwise_causal_prefix_attn(
        *map(jnp.asarray, kl), jnp.asarray(sb), interpret=True,
        return_residuals=residuals, **kw)
    n0 = tbca.blockwise_causal_prefix_attn.launches
    got = tbca.blockwise_causal_prefix_attn(
        *map(torch.from_numpy, kl), torch.from_numpy(sb),
        return_residuals=residuals, **kw)
    assert tbca.blockwise_causal_prefix_attn.launches == n0  # no kernel
    if not residuals:
        got, want = (got,), (want,)
    _close(got[0], want[0])
    if residuals:
        _close(got[1], want[1])
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-5)
    ref = jcausal.blockwise_causal_prefix_attention(
        *map(jnp.asarray, xs), jnp.asarray(sb), **kw)
    _close(got[0].movedim(1, 2), ref)


@pytest.mark.parametrize("backend", ["auto", "reference"])
def test_chunk_prefill_routes_match_jax(backend):
    """plan.chunk_prefill_attention on both routes (kernel twin, reference)
    against ops.fused_chunk_prefill_attention in interpret mode."""
    xs = _prefix_inputs(2 * HKV, seed=20)
    sb = np.asarray(STARTS, np.int32)
    kw = dict(block_size=C, block_slots=R, scale=DH ** -0.5)
    want = jops.fused_chunk_prefill_attention(
        *map(jnp.asarray, xs), jnp.asarray(sb), interpret=True, **kw)
    got = tplan.AttentionPlan(backend=backend).chunk_prefill_attention(
        *map(torch.from_numpy, xs), torch.from_numpy(sb), **kw)
    _close(got, want)


@pytest.mark.parametrize("backward_impl", ["fused", "reference"])
@pytest.mark.parametrize("G", [1, 2])
def test_chunk_prefill_vjp_matches_jax(G, backward_impl):
    """The prefix form's VJP through plan.chunk_prefill_attention on the
    kernel route, both backward routes (the kernel twins of 4r and of 2
    with start blocks; autograd through the plain prefix form), against
    jax.vjp of ops.fused_chunk_prefill_attention in interpret mode with the
    same backward_impl: dq, dk, dv, dcomp_k and dcomp_v within 1e-5 of each
    tensor's largest entry, exact zeros on the slots no row sees."""
    xs = _prefix_inputs(G * HKV, seed=21 + G)
    sb = np.asarray(STARTS, np.int32)
    do = _np(np.random.default_rng(25 + G), len(STARTS), P, G * HKV, DH)
    kw = dict(block_size=C, block_slots=R, scale=DH ** -0.5)
    _, vjp = jax.vjp(lambda *a: jops.fused_chunk_prefill_attention(
        *a, jnp.asarray(sb), interpret=True, backward_impl=backward_impl,
        **kw), *map(jnp.asarray, xs))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = tplan.AttentionPlan(
        backend="auto", backward_impl=backward_impl).chunk_prefill_attention(
            *leaves, torch.from_numpy(sb), **kw)
    fused = type(out.grad_fn).__name__.startswith("ChunkPrefillAttnFn")
    assert fused == (backward_impl == "fused")
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    unseen = np.arange(M_SLOTS)[None] // R >= sb[:, None] + P // C - 1
    for name, g, w in zip(("dq", "dk", "dv", "dcomp_k", "dcomp_v"), got,
                          want):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL * scale, rtol=0,
                                   err_msg=name)
        if name.startswith("dcomp"):
            assert unseen.any() and not g.numpy()[unseen].any()
            assert not w[unseen].any()


def test_quantized_chunk_prefill_is_forward_only():
    """fused_chunk_prefill_attention_q refuses a gradient (the JAX
    package's wrapper is a plain jit with no VJP); without one it runs."""
    q, k, v, _, _ = (torch.from_numpy(x)
                     for x in _prefix_inputs(2 * HKV, seed=27))
    B = len(STARTS)
    codes = torch.ones(B, M_SLOTS, HKV, DH, dtype=torch.int8)
    scales = torch.full((B, M_SLOTS, HKV), 0.5)
    args = (k, v, codes, codes, scales, scales, torch.tensor(STARTS))
    kw = dict(block_size=C, block_slots=R, scale=DH ** -0.5)
    out = tops.fused_chunk_prefill_attention_q(q, *args, **kw)
    assert out.shape == q.shape
    with pytest.raises(NotImplementedError, match="forward-only"):
        tops.fused_chunk_prefill_attention_q(q.requires_grad_(), *args,
                                             **kw)


@pytest.mark.parametrize("per_head", [False, True])
def test_compressed_prefill_chunk_matches_jax(per_head):
    """One chunk into a layer cache at per-row offsets (t0 = 0, 2c, 5c):
    attention output and every cache leaf; the ring stays untouched."""
    rng = np.random.default_rng(30 + per_head)
    B = len(STARTS)
    q, k, v = (_np(rng, B, P, 2 * HKV, DH), _np(rng, B, P, HKV, DH),
               _np(rng, B, P, HKV, DH))
    shape = (HKV, C, R) if per_head else (C, R)
    E, F = _np(rng, *shape) * R ** -0.5, _np(rng, *shape) * R ** -0.5
    cache = {"raw_k": _np(rng, B, C, HKV, DH), "raw_v": _np(rng, B, C, HKV, DH),
             "comp_k": _np(rng, B, M_SLOTS, HKV, DH),
             "comp_v": _np(rng, B, M_SLOTS, HKV, DH)}
    t0 = np.asarray(STARTS, np.int32) * C
    want_out, want_cache = jcache.compressed_prefill_chunk(
        *map(jnp.asarray, (q, k, v)), {n: jnp.asarray(x)
                                       for n, x in cache.items()},
        jnp.asarray(E), jnp.asarray(F), jnp.asarray(t0), plan="fused")
    tc = {n: torch.from_numpy(x.copy()) for n, x in cache.items()}
    got_out, got_cache = tcache.compressed_prefill_chunk(
        *map(torch.from_numpy, (q, k, v)), tc, torch.from_numpy(E),
        torch.from_numpy(F), torch.from_numpy(t0), plan="auto")
    assert got_cache is tc                              # updated in place
    _close(got_out, want_out)
    for name in cache:
        _close(got_cache[name], want_cache[name])
    np.testing.assert_array_equal(tc["raw_k"].numpy(), cache["raw_k"])


MAX_SEQ = 96
DECODE_CHUNK = 4


@pytest.fixture(scope="module")
def setup():
    cfg_j = dataclasses.replace(jax_smoke_config("qwen3-8b"),
                                dtype="float32")
    params_j = jmodel.init_params(jax.random.PRNGKey(2), cfg_j)
    flat = {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params_j)[0]}
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    params_t = bridge.params_from_flat(flat, cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def test_model_prefill_chunk_matches_jax(setup):
    """Two prefill chunks per row through model.prefill_chunk, rows at
    unequal offsets and valid counts (one row padded with a whole garbage
    block): logits and every cache leaf after each chunk."""
    cfg_j, params_j, cfg_t, params_t = setup
    B = 3
    cache_j = jmodel.init_cache(cfg_j, batch=B, max_seq=MAX_SEQ + P,
                                dtype=jnp.float32)
    cache_t = tmodel.init_cache(cfg_t, batch=B, max_seq=MAX_SEQ + P,
                                dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(40)
    for n_valid in ([P, C, P], [C, P, P]):
        toks = rng.integers(4, cfg_j.vocab_size, (B, P)).astype(np.int32)
        nv = np.asarray(n_valid, np.int32)
        lj, cache_j = jmodel.prefill_chunk(
            params_j, cfg_j, {"tokens": jnp.asarray(toks)}, cache_j,
            jnp.asarray(nv))
        lt, cache_t = tmodel.prefill_chunk(
            params_t, cfg_t, torch.from_numpy(toks.astype(np.int64)),
            cache_t, torch.from_numpy(nv))
        _close(lt, lj)
        for name in cache_j:
            _close(cache_t[name], cache_j[name])


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(4, vocab, n))) for n in lens]


# lengths: below one block, exact block and chunk multiples, remainders,
# a prompt that needs three chunks; every budget crosses a block boundary
PROMPT_LENS = [9, 16, 35, 64, 48, 77, 19, 33]
BUDGETS = [12, 19, 9, 17, 14, 11, 16, 10]


@pytest.fixture(scope="module")
def served(setup):
    """The port's chunked and monolithic engines and the JAX chunked engine
    on the same prompts (arrivals staggered)."""
    cfg_j, params_j, cfg_t, params_t = setup
    prompts = _prompts(cfg_j.vocab_size, PROMPT_LENS, seed=41)
    arrivals = [0, 0, 1, 1, 2, 4, 4, 6]
    kw = dict(max_seq=MAX_SEQ, decode_chunk=DECODE_CHUNK)
    jeng = JaxEngine(params_j, cfg_j, cache_dtype=jnp.float32,
                     prefill_chunk=P, **kw)
    want, jsched = jeng.serve(prompts, BUDGETS, max_batch=3,
                              arrival_chunks=arrivals, return_scheduler=True)
    out = {}
    for pc in (P, 0):
        eng = ServingEngine(params_t, cfg_t, device="cpu",
                            cache_dtype=torch.float32, prefill_chunk=pc,
                            **kw)
        out[pc] = eng.serve(prompts, BUDGETS, max_batch=3,
                            arrival_chunks=arrivals, return_scheduler=True)
    return want, jsched, out


def test_chunked_serve_matches_jax_engine(served):
    want, jsched, out = served
    got, sched = out[P]
    assert got == want
    assert [len(o) for o in got] == BUDGETS        # no EOS at random init
    assert sched.stats.prefill_forwards == jsched.stats.prefill_forwards
    assert sched.stats.prefill_tokens == jsched.stats.prefill_tokens \
        == sum(PROMPT_LENS)
    assert sched.stats.chunks == jsched.stats.chunks
    assert sched.stats.quarantines == 0


def test_chunked_serve_matches_monolithic(served):
    _, _, out = served
    (chunked, cs), (mono, ms) = out[P], out[0]
    assert chunked == mono
    assert ms.stats.prefill_forwards == len(PROMPT_LENS)   # one B=1 each
    assert cs.stats.prefill_tokens == ms.stats.prefill_tokens


def test_padded_final_chunk_near_max_seq(setup):
    """A padded final chunk whose window crosses max_seq writes into the
    pool's slack, never clamped down over valid slots: chunked == JAX."""
    cfg_j, params_j, cfg_t, params_t = setup
    prompts = _prompts(cfg_j.vocab_size, [90, 92, 45], seed=42)
    kw = dict(max_seq=MAX_SEQ, decode_chunk=DECODE_CHUNK, prefill_chunk=64)
    want = JaxEngine(params_j, cfg_j, cache_dtype=jnp.float32, **kw).serve(
        prompts, [4, 3, 4], max_batch=2)
    eng = ServingEngine(params_t, cfg_t, device="cpu",
                        cache_dtype=torch.float32, **kw)
    assert eng.serve(prompts, [4, 3, 4], max_batch=2) == want
    mono = ServingEngine(params_t, cfg_t, device="cpu",
                         cache_dtype=torch.float32, max_seq=MAX_SEQ,
                         decode_chunk=DECODE_CHUNK)
    assert mono.serve(prompts, [4, 3, 4], max_batch=2) == want


def test_invalid_prefill_chunk_rejected_as_in_jax(setup):
    cfg_j, params_j, cfg_t, params_t = setup
    for bad in (24, 8, -16):
        with pytest.raises(ValueError, match="prefill_chunk") as jerr:
            JaxEngine(params_j, cfg_j, max_seq=MAX_SEQ, prefill_chunk=bad)
        with pytest.raises(ValueError, match="prefill_chunk") as terr:
            ServingEngine(params_t, cfg_t, max_seq=MAX_SEQ, device="cpu",
                          prefill_chunk=bad)
        assert str(terr.value) == str(jerr.value)


def test_launcher_chunked_matches_monolithic():
    argv = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
            "--requests", "5", "--max-new-tokens", "6"]
    assert tserve.main(argv + ["--prefill-chunk", "32"]) == tserve.main(argv)

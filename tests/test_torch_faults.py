"""Fault injection, quarantine and snapshots: the PyTorch port against the
JAX package on qwen3-8b SMOKE in fp32 with bridged weights, on the CPU.

Mirrors tests/test_serving_faults.py. Every fired fault is detected and
the faulty request completes with the fault-free tokens, and the port's
outputs, `ShedResult`s, `ScheduleStats` counters and `FaultInjector.fired`
list equal JAX's on the same trace (the seeded random schedule included).
The row surgery is held leaf by leaf, byte for byte, to JAX's jitted
`_corrupt_row_impl`, `_corrupt_row_paged_impl`, `_scrub_row_impl` and
`_scrub_row_paged_impl` on the same pool (dense fp32, bf16 and int8
leaves; paged int8 and fp8), and a snapshot captured by JAX restores into
the port and resumes to JAX's tokens.

`REPRO_FAULT_SEED` selects the random schedule's seed, as for the JAX
suite."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as jmodel
from repro.serving import FaultInjector as JaxInjector
from repro.serving import Fault as JaxFault
from repro.serving import ShedResult as JaxShed
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import Request as JaxRequest
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro.serving.scheduler import SlotPool as JaxSlotPool
from repro.serving.scheduler import _STAT_COUNTERS
from repro.serving.snapshot import cache_rows_checksum as jax_checksum

from repro_torch.checkpoint import bridge
from repro_torch.configs import config_from_dict
from repro_torch.serving import (Fault, FaultInjector, Request, Scheduler,
                                 ServingEngine, ShedResult, SlotPool)
from repro_torch.serving.faults import (FAULT_KINDS, NAN_LOGITS, SLOT_STEP,
                                        SNAPSHOT_CORRUPT)
from repro_torch.serving.snapshot import (cache_rows_checksum, capture,
                                          leaf_bytes)

FAULT_SEED = int(os.environ.get("REPRO_FAULT_SEED", "0"))
MAX_SEQ = 96
DECODE_CHUNK = 4
P = 32

POOLS = {"dense-mono": dict(),
         "dense-chunked": dict(prefill_chunk=P),
         "paged-int8": dict(prefill_chunk=P, cache_format="paged"),
         "paged-fp8": dict(prefill_chunk=P, cache_format="paged",
                           page_dtype="fp8"),
         "paged-int8-mono": dict(cache_format="paged"),
         "paged-fp8-mono": dict(cache_format="paged", page_dtype="fp8")}


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
    cfg_j = dataclasses.replace(jax_smoke_config("qwen3-8b"),
                                dtype="float32")
    params_j = jmodel.init_params(jax.random.PRNGKey(7), cfg_j)
    flat = {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params_j)[0]}
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    params_t = bridge.params_from_flat(flat, cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture(scope="module")
def engines(setup):
    cfg_j, params_j, cfg_t, params_t = setup
    out = {}
    for name, kw in POOLS.items():
        kw = dict(max_seq=MAX_SEQ, decode_chunk=DECODE_CHUNK, **kw)
        out[name] = (JaxEngine(params_j, cfg_j, cache_dtype=jnp.float32,
                               **kw),
                     ServingEngine(params_t, cfg_t, device="cpu",
                                   cache_dtype=torch.float32, **kw))
    return out


@pytest.fixture(scope="module")
def clean(engines):
    """The fault-free tokens of the 8 requests (the port's static baseline,
    whose tokens equal JAX's)."""
    prompts, budgets = _requests(8)
    return engines["dense-mono"][1].serve_static(prompts, budgets,
                                                 max_batch=4)


@pytest.fixture(scope="module")
def clean_paged(engines):
    """{page dtype: fault-free tokens of a paged serve} (quantized pages
    round: a paged pool's tokens are held to its own fault-free run)."""
    prompts, budgets = _requests(8)
    return {pd: engines[f"paged-{pd}"][1].serve(prompts, budgets,
                                                max_batch=4)
            for pd in ("int8", "fp8")}


def _requests(n=8, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(4, 512, int(rng.choice(
        [9, 16, 19, 35]))))) for _ in range(n)]
    budgets = [int(rng.choice([3, 6, 10, 17])) for _ in range(n)]
    return prompts, budgets


def _stats(st):
    return {**{k: getattr(st, k) for k in _STAT_COUNTERS}, "ticks": st.ticks}


def _norm(outs):
    return [dataclasses.astuple(o) if isinstance(o, (ShedResult, JaxShed))
            else o for o in outs]


def _faults(inj):
    return [(f.kind, f.chunk, f.row) for f in inj.fired], \
        [(f.kind, f.chunk, f.row) for f in inj.skipped]


def serve_both(engines, pool, make_injector, prompts=None, budgets=None,
               **kw):
    """Serve one trace through both schedulers, each with its own injector
    from `make_injector(Fault, FaultInjector)`; assert identical outputs,
    ShedResults, counters and fired faults. Returns the port's (outputs,
    scheduler, injector)."""
    if prompts is None:
        prompts, budgets = _requests(8)
    jeng, teng = engines[pool]
    jinj = make_injector(JaxFault, JaxInjector)
    tinj = make_injector(Fault, FaultInjector)
    want, jsched = jeng.serve(prompts, budgets, fault_injector=jinj,
                              return_scheduler=True, **kw)
    got, sched = teng.serve(prompts, budgets, fault_injector=tinj,
                            return_scheduler=True, **kw)
    assert _norm(got) == _norm(want)
    assert _stats(sched.stats) == _stats(jsched.stats)
    assert _faults(tinj) == _faults(jinj)
    if sched.pool.paged:
        sched.pool.alloc.check()
        assert sched.pool.alloc.free_pages == sched.pool.alloc.usable_pages
    return got, sched, tinj


# ---------------------------------------------------------------------------
# detection and recovery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool", ["dense-mono", "dense-chunked",
                                  "paged-int8", "paged-fp8"])
@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_fault_detected_and_recovered_as_in_jax(engines, clean, clean_paged,
                                                kind, pool):
    """One fault of each kind, both admission modes, dense and paged: it is
    detected (quarantine), the request is requeued, and every output
    equals the fault-free run; a flipped snapshot byte is caught by the
    checksum at restore."""
    out, sched, inj = serve_both(
        engines, pool, lambda F, I: I([F(kind, chunk=2, row=1)]),
        max_batch=4, snapshot_chunks=2)
    assert len(inj.fired) == 1
    assert sched.stats.quarantines == 1 and sched.stats.retries == 1
    assert sched.stats.snapshot_corruptions == (kind == SNAPSHOT_CORRUPT)
    assert out == (clean_paged[pool[6:]] if sched.pool.paged else clean)


def test_nan_guard_quarantines_instead_of_streaming(engines, clean):
    prompts, budgets = _requests(8)
    streamed = {i: [] for i in range(8)}
    out, sched = engines["dense-mono"][1].serve(
        prompts, budgets, max_batch=4, snapshot_chunks=1,
        fault_injector=FaultInjector([Fault(NAN_LOGITS, chunk=1, row=0)]),
        return_scheduler=True,
        on_token=lambda rid, tok: streamed[rid].append(tok))
    assert sched.stats.quarantines == 1
    assert out == clean
    assert [streamed[i] for i in range(8)] == out
    serve_both(engines, "dense-mono",
               lambda F, I: I([F(NAN_LOGITS, chunk=1, row=0)]),
               max_batch=4, snapshot_chunks=1)


def test_nan_guard_off_streams_garbage(engines, clean):
    """Negative control: with the guard off the NaN poison reaches the
    output, in both packages alike."""
    out, sched, _ = serve_both(
        engines, "dense-mono",
        lambda F, I: I([F(NAN_LOGITS, chunk=1, row=0)]),
        max_batch=4, nan_guard=False)
    assert sched.stats.quarantines == 0
    assert out != clean


def test_undetectable_garble_diverges(engines, clean):
    """Negative control: detectable=False keeps the corruption and silences
    the report, so the run streams other tokens than the fault-free one
    (and the same as JAX's: the garble is JAX's, bit for bit)."""
    out, sched, _ = serve_both(
        engines, "dense-mono",
        lambda F, I: I([F(SLOT_STEP, chunk=1, row=0)], detectable=False),
        max_batch=4)
    assert sched.stats.quarantines == 0
    assert out != clean


# seed 2 on the paged pool: seeds 1 and 3 make JAX's injector raise or its
# scheduler block (test_corrupt_snapshot_never_blocks_the_queue)
@pytest.mark.parametrize("pool,seed", [("dense-chunked", FAULT_SEED),
                                       ("paged-int8", 2)])
def test_randomized_schedule_fires_as_in_jax(engines, clean, clean_paged,
                                             pool, seed):
    """A seeded random schedule draws the same (chunk, kind) pairs, picks
    the same live rows and flips the same snapshot bytes in both packages:
    the same fired list, every fault quarantined, every request
    complete."""
    out, sched, inj = serve_both(
        engines, pool,
        lambda F, I: I(seed=seed, n_random=3, horizon=10),
        max_batch=4, snapshot_chunks=2, max_retries=5)
    assert len(inj.fired) + len(inj.skipped) >= 3
    assert sched.stats.quarantines == len(inj.fired)
    assert out == (clean_paged[pool[6:]] if sched.pool.paged else clean)


class _Draws:
    """Stands in for an injector's generator: each `integers` call returns
    the next scripted value."""

    def __init__(self, values):
        self.values = list(values)

    def integers(self, n):
        v = self.values.pop(0)
        assert 0 <= v < n
        return v


def test_corrupt_snapshot_never_blocks_the_queue(engines, clean_paged):
    """A flip in a paged snapshot's `lengths` leaf (byte 1: +65280 tokens)
    must not be trusted for the page headroom: the port checks the
    checksum first, so the request restarts from its prompt, where JAX
    asks for ~4000 pages forever and blocks the queue."""
    prompts, budgets = _requests(8)
    inj = FaultInjector([Fault(SNAPSHOT_CORRUPT, chunk=2, row=1)])
    inj._rng = _Draws([0, 1])             # sorted keys: "lengths" first
    out, sched = engines["paged-int8"][1].serve(
        prompts, budgets, max_batch=4, snapshot_chunks=2,
        fault_injector=inj, return_scheduler=True)
    assert len(inj.fired) == 1 and sched.stats.snapshot_corruptions == 1
    assert out == clean_paged["int8"]


def test_flip_in_an_empty_leaf_is_skipped(engines):
    """A paged snapshot of a row with no committed block holds empty page
    leaves: a flip drawn there has no byte to hit, so the fault is
    recorded as skipped (JAX's draw raises), and the garbled row is still
    quarantined and recovered."""
    _, teng = engines["paged-int8"]
    rng = np.random.default_rng(11)
    prompts = [list(map(int, rng.integers(4, 512, 9))) for _ in range(3)]
    clean = teng.serve(prompts, 6, max_batch=3)
    inj = FaultInjector([Fault(SNAPSHOT_CORRUPT, chunk=1, row=1)])
    inj._rng = _Draws([1])                # "pages_k": 0 pages at 13 tokens
    out, sched = teng.serve(prompts, 6, max_batch=3, snapshot_chunks=1,
                            fault_injector=inj, return_scheduler=True)
    assert [f.kind for f in inj.skipped] == [SNAPSHOT_CORRUPT]
    assert not inj.fired
    assert sched.stats.quarantines == 1
    assert sched.stats.snapshot_corruptions == 0
    assert out == clean


def test_retries_exhausted_sheds_explicitly(engines, clean):
    prompts, budgets = _requests(4)
    out, sched, _ = serve_both(
        engines, "dense-mono",
        lambda F, I: I([F(SLOT_STEP, chunk=c, row=0) for c in range(12)]),
        prompts, budgets, max_batch=1, max_retries=1)
    shed = [o for o in out if isinstance(o, ShedResult)]
    assert shed and all(o.reason == "retries_exhausted" for o in shed)
    assert sched.stats.sheds == len(shed)
    for o, c in zip(out, clean):
        assert isinstance(o, ShedResult) or o == c


def _admissions(sched):
    """Record (row, rid) of every admission into `sched`'s pool."""
    events = []
    pool = sched.pool
    for name in ("admit", "begin_prefill", "restore"):
        def wrapped(row, req, *a, _fn=getattr(pool, name)):
            events.append((row, req.rid))
            return _fn(row, req, *a)
        setattr(pool, name, wrapped)
    return events


@pytest.mark.parametrize("pool", ["dense-mono", "paged-int8-mono"])
def test_quarantined_row_reoccupied(engines, clean, pool):
    """After a NaN quarantine the scrubbed row takes new tenants, whose
    tokens equal the fault-free ones: no NaN leaks from the row's past
    (JAX's admissions row by row are the same)."""
    prompts, budgets = _requests(8)
    jeng, teng = engines[pool]
    scheds = {}
    for key, eng, S, R, F, I in (
            ("jax", jeng, JaxScheduler, JaxRequest, JaxFault, JaxInjector),
            ("torch", teng, Scheduler, Request, Fault, FaultInjector)):
        sched = S(eng, 2, fault_injector=I([F(NAN_LOGITS, chunk=1,
                                             row=0)]))
        events = _admissions(sched)
        for i, p in enumerate(prompts):
            sched.submit(R(rid=i, tokens=tuple(p),
                           max_new_tokens=budgets[i]))
        scheds[key] = (sched, events, sched.run())
    (js, jev, jres), (ts, tev, tres) = scheds["jax"], scheds["torch"]
    assert tev == jev
    assert _stats(ts.stats) == _stats(js.stats)
    # paged: the plain route reads page 0 for unallocated table entries, so
    # NaN scales there reach a neighbour's masked slots too (in both
    # packages alike; the card's decode kernels skip masked keys)
    assert ts.stats.quarantines >= 1
    assert [tres[i] for i in range(8)] == (
        teng.serve(prompts, budgets, max_batch=2) if teng.paged else clean)
    faulty = next(rid for row, rid in tev if row == 0)
    later = [rid for row, rid in tev[tev.index((0, faulty)) + 1:]
             if row == 0]
    assert later and faulty in [rid for _, rid in tev[2:]]


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------


def _to_torch(a):
    """A JAX or numpy array as a CPU torch tensor with the same bytes."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _same_bytes(t, a):
    return leaf_bytes(t).numpy().tobytes() == \
        np.ascontiguousarray(np.asarray(a)).tobytes()


def _snap():
    rows = {"comp_k": torch.arange(24, dtype=torch.float32).reshape(
        2, 1, 3, 4), "lengths": torch.tensor([5], dtype=torch.int32)}
    return capture(rid=1, state="decoding", filled=5, cur=7, finished=False,
                   emitted=[1, 2], cache_rows=rows, tick=3)


def test_snapshot_verify_roundtrip_and_bitflip():
    snap = _snap()
    assert snap.verify() and snap.nbytes == 24 * 4 + 4
    leaf_bytes(snap.cache_rows["comp_k"])[3] ^= 0xFF
    assert not snap.verify()


def test_capture_copies():
    rows = {"x": torch.ones(2, 1)}
    snap = capture(rid=0, state="decoding", filled=0, cur=1, finished=False,
                   emitted=[], cache_rows=rows, tick=0)
    rows["x"][:] = 9.0
    assert snap.verify() and snap.cache_rows["x"].eq(1).all()


def test_checksum_equals_jax_on_the_same_bytes():
    """The CRC walks the same bytes in the same order as JAX's, for every
    leaf dtype a pool holds (fp32, bf16, fp8, int8, int32)."""
    rng = np.random.default_rng(0)
    leaves = {"a": rng.standard_normal((2, 1, 3)).astype(np.float32),
              "b": np.asarray(jnp.asarray(rng.standard_normal(5),
                                          jnp.bfloat16)),
              "c": rng.integers(0, 0x7E, 6).astype(np.uint8).view(
                  jnp.float8_e4m3fn),
              "d": rng.integers(-128, 128, 7).astype(np.int8),
              "lengths": np.asarray([9], np.int32)}
    assert cache_rows_checksum({k: _to_torch(v) for k, v in leaves.items()}) \
        == jax_checksum(leaves)


def _paged_pool_with_row(engines, pool_name="paged-int8-mono"):
    """A 2-row paged pool of each package holding the same request in
    row 0 (19 tokens: 1 committed page and a 3-token ring)."""
    jeng, teng = engines[pool_name]
    prompt = list(range(4, 23))
    out = []
    for eng, Pool, Req, toks in ((jeng, JaxSlotPool, JaxRequest, np.int32),
                                 (teng, SlotPool, Request, np.int64)):
        pool = Pool(eng, max_batch=2)
        cache, logits = eng.prefill(np.asarray([prompt], toks))
        pool.admit(0, Req(rid=0, tokens=tuple(prompt), max_new_tokens=4),
                   cache, int(np.argmax(np.asarray(logits[0]))))
        out.append(pool)
    return out


def test_paged_snapshot_carries_scale_leaves(engines):
    jpool, tpool = _paged_pool_with_row(engines)
    jsnap = jpool.snapshot_rows([0], tick=0)[0]
    snap = tpool.snapshot_rows([0], tick=0)[0]
    assert sorted(snap.cache_rows) == sorted(jsnap.cache_rows)
    for key in ("pages_k_s", "pages_v_s", "raw_k_s", "raw_v_s"):
        leaf = snap.cache_rows[key]
        assert leaf.dtype == torch.float32 and leaf.numel() > 0, key
    assert snap.cache_rows["pages_k"].dtype == torch.int8
    for k, v in snap.cache_rows.items():
        assert tuple(v.shape) == jsnap.cache_rows[k].shape, k
    assert snap.verify()


@pytest.mark.parametrize("key", ["pages_k_s", "pages_v_s", "raw_k_s",
                                 "raw_v_s", "pages_k"])
def test_single_leaf_flip_fails_verify(engines, key):
    """One byte of ONE leaf, a scale leaf or a payload, fails verify()."""
    _, tpool = _paged_pool_with_row(engines)
    snap = tpool.snapshot_rows([0], tick=0)[0]
    assert snap.verify()
    leaf_bytes(snap.cache_rows[key])[1] ^= 0xFF
    assert not snap.verify()


def test_injector_targets_scale_leaves(engines):
    _, tpool = _paged_pool_with_row(engines)
    keys = sorted(tpool.snapshot_rows([0], tick=0)[0].cache_rows)
    rng = np.random.default_rng(0)
    hit = {keys[int(rng.integers(len(keys)))] for _ in range(256)}
    assert any(k.endswith("_s") for k in hit)


@pytest.mark.parametrize("pool", ["dense-mono", "paged-fp8-mono"])
def test_jax_snapshot_resumes_in_the_port(engines, pool):
    """A snapshot JAX captured after one decode chunk, its leaves moved
    byte for byte into the port (same checksum), restores into another row
    of the port's pool and decodes JAX's next tokens."""
    jeng, teng = engines[pool]
    prompt = list(map(int, np.random.default_rng(3).integers(4, 512, 35)))
    jpool = JaxSlotPool(jeng, max_batch=2)
    cache, logits = jeng.prefill(np.asarray([prompt], np.int32))
    req = dict(rid=0, tokens=tuple(prompt), max_new_tokens=12)
    jpool.admit(0, JaxRequest(**req), cache, int(jnp.argmax(logits[0])))
    rng = jax.random.PRNGKey(0)
    first, _, rng = jpool.decode_chunk(DECODE_CHUNK, rng)
    jpool.slots[0].emitted.extend(first[0].tolist())
    jsnap = jpool.snapshot_rows([0], tick=1)[0]
    want = [jpool.decode_chunk(DECODE_CHUNK, rng)[0][0].tolist()]
    rng = jax.random.PRNGKey(1)
    want.append(jpool.decode_chunk(DECODE_CHUNK, rng)[0][0].tolist())

    snap = capture(rid=jsnap.rid, state=jsnap.state, filled=jsnap.filled,
                   cur=jsnap.cur, finished=jsnap.finished,
                   emitted=jsnap.emitted, tick=jsnap.tick,
                   cache_rows={k: _to_torch(v)
                               for k, v in jsnap.cache_rows.items()})
    assert snap.checksum == jsnap.checksum
    tpool = SlotPool(teng, max_batch=2)
    tpool.restore(1, Request(**req), snap)
    got = [tpool.decode_chunk(DECODE_CHUNK, None)[0][1].tolist()
           for _ in range(2)]
    assert got == want
    assert tpool.slots[1].emitted == first[0].tolist()


# ---------------------------------------------------------------------------
# row surgery, leaf by leaf against JAX's jitted implementations
# ---------------------------------------------------------------------------


def _random_leaf(rng, shape, dtype, key):
    if key == "lengths":
        return rng.integers(0, 40, shape).astype(np.int32)
    if key == "page_table":
        return rng.integers(-1, 8, shape).astype(np.int32)
    if dtype == jnp.float8_e4m3fn:
        # every finite code, the largest ones included (their garble
        # overflows to NaN, as JAX rounds it)
        codes = rng.integers(0, 0x7F, shape).astype(np.uint8)
        sign = rng.integers(0, 2, shape).astype(np.uint8) << 7
        return (codes | sign).view(jnp.float8_e4m3fn)
    if dtype == np.int8:
        return rng.integers(-128, 128, shape).astype(np.int8)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    if key.endswith("_s"):
        x = np.abs(x) / 100
    return np.asarray(jnp.asarray(x, dtype))


def _random_pool(eng, max_batch, seed, int8_leaf=False):
    rng = np.random.default_rng(seed)
    pool = {k: _random_leaf(rng, v.shape, v.dtype, k)
            for k, v in eng.init_pool_cache(max_batch).items()}
    if int8_leaf:                      # a dense pool leaf of integer dtype
        pool["codes"] = _random_leaf(rng, (2, max_batch, 5), np.int8,
                                     "codes")
    return pool


SURGERY = {"dense-fp32": ("dense-mono", {}),
           "dense-bf16": ("dense-mono", {"cache_dtype": "bf16"}),
           "dense-int8-leaf": ("dense-mono", {"int8_leaf": True}),
           "paged-int8": ("paged-int8", {}),
           "paged-fp8": ("paged-fp8", {})}


def _surgery_engines(setup, engines, name):
    pool_name, opt = SURGERY[name]
    jeng, teng = engines[pool_name]
    if opt.get("cache_dtype") == "bf16":
        cfg_j, params_j, cfg_t, params_t = setup
        kw = dict(max_seq=MAX_SEQ, decode_chunk=DECODE_CHUNK)
        jeng = JaxEngine(params_j, cfg_j, cache_dtype=jnp.bfloat16, **kw)
        teng = ServingEngine(params_t, cfg_t, device="cpu",
                             cache_dtype=torch.bfloat16, **kw)
    return jeng, teng, opt.get("int8_leaf", False)


@pytest.mark.parametrize("op", ["garble", "nan", "scrub"])
@pytest.mark.parametrize("name", list(SURGERY))
def test_row_surgery_leaf_by_leaf_as_in_jax(setup, engines, name, op):
    """corrupt_pool_row(_paged) in both modes and scrub_pool_row against
    JAX's jitted implementations on the same pool: every leaf byte-equal,
    the other row untouched. fp32 garble as XLA:CPU fuses it (one
    rounding), bf16 and fp8 one rounding per op in the leaf's dtype, fp8
    overflow to NaN; int8: -1·x + 0 dense, x ^ 0x55 paged; NaN enters a
    paged pool through its fp32 scales."""
    jeng, teng, int8_leaf = _surgery_engines(setup, engines, name)
    before = _random_pool(jeng, 3, seed=len(name), int8_leaf=int8_leaf)
    jpool = {k: jnp.asarray(v) for k, v in before.items()}   # donated
    tpool = {k: _to_torch(v) for k, v in before.items()}
    row, pages = 1, [4, 0, 6]
    if op == "scrub":
        if int8_leaf:
            want = jax.jit(JaxEngine._scrub_row_impl)(
                jpool, jnp.asarray(row, jnp.int32))
        else:
            want = jeng.scrub_pool_row(jpool, row)
        got = teng.scrub_pool_row(tpool, row)
    elif jeng.paged:
        want = jeng.corrupt_pool_row_paged(jpool, row, pages, op)
        got = teng.corrupt_pool_row_paged(tpool, row, pages, op)
    else:
        want = jax.jit(JaxEngine._corrupt_row_impl, static_argnums=(2,))(
            jpool, jnp.asarray(row, jnp.int32), op)
        got = ServingEngine.corrupt_pool_row(tpool, row, op)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _same_bytes(got[k], want[k]), k
    assert any(not _same_bytes(got[k], before[k]) for k in want)


def test_corruption_modes_rejected_as_in_jax(engines):
    jeng, teng = engines["paged-int8"]
    tpool = teng.init_pool_cache(2)
    with pytest.raises(ValueError, match="unknown corruption mode"):
        teng.corrupt_pool_row_paged(tpool, 0, [], "bitrot")
    with pytest.raises(ValueError, match="unknown corruption mode"):
        ServingEngine.corrupt_pool_row(tpool, 0, "bitrot")
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault(kind="cosmic_ray", chunk=0)


def test_paged_restore_checks_the_page_count(engines):
    """Restoring a snapshot into a different number of pages raises JAX's
    ValueError."""
    _, tpool = _paged_pool_with_row(engines)
    snap = tpool.snapshot_rows([0], tick=0)[0]
    with pytest.raises(ValueError, match="snapshot holds 1 pages"):
        tpool.engine.restore_pool_rows_paged(tpool.cache, snap.cache_rows,
                                             1, [3, 4])

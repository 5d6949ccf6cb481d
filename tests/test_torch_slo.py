"""SLO scheduling parity: the PyTorch port's scheduler against the JAX
scheduler on qwen3-8b SMOKE in fp32 with bridged weights, on the CPU.

Mirrors tests/test_serving_scheduler.py (preemption, EDF, bounded queue,
deadlines) on the dense pool (monolithic and chunked admission) and the
paged int8/fp8 pools. Every case requires the port's outputs, every
`ShedResult` (rid, reason, tick, priority) and every `ScheduleStats`
counter to equal JAX's on the same trace: the decisions are made on the
host from ticks, sort keys and page counts, so any difference in tick
accounting shows up here. Greedy tokens must be identical (fp32), and
equal to the port's static bucketed baseline."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as jmodel
from repro.serving import ShedResult as JaxShed
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.scheduler import _STAT_COUNTERS

from repro_torch.checkpoint import bridge
from repro_torch.configs import config_from_dict
from repro_torch.serving import ServingEngine, ShedResult

MAX_SEQ = 96
DECODE_CHUNK = 4
P = 32                                  # chunked admission: two blocks

POOLS = {"dense-mono": dict(),
         "dense-chunked": dict(prefill_chunk=P),
         "paged-int8": dict(prefill_chunk=P, cache_format="paged"),
         "paged-fp8": dict(prefill_chunk=P, cache_format="paged",
                           page_dtype="fp8"),
         # 6 usable pages: prefills stall, and decode chunks preempt
         "paged-tight": dict(prefill_chunk=P, cache_format="paged",
                             arena_pages=7)}


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
    params_j = jmodel.init_params(jax.random.PRNGKey(5), cfg_j)
    flat = {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params_j)[0]}
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    params_t = bridge.params_from_flat(flat, cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture(scope="module")
def engines(setup):
    """{pool name: (JAX engine, port engine)}, built once."""
    cfg_j, params_j, cfg_t, params_t = setup
    out = {}
    for name, kw in POOLS.items():
        kw = dict(max_seq=MAX_SEQ, decode_chunk=DECODE_CHUNK, **kw)
        out[name] = (JaxEngine(params_j, cfg_j, cache_dtype=jnp.float32,
                               **kw),
                     ServingEngine(params_t, cfg_t, device="cpu",
                                   cache_dtype=torch.float32, **kw))
    return out


def _requests(n, seed):
    """Prompts below one block, at whole blocks and with remainders;
    budgets that cross block boundaries while decoding."""
    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(4, 512, int(rng.choice(
        [9, 16, 19, 35]))))) for _ in range(n)]
    budgets = [int(rng.choice([3, 6, 10, 17])) for _ in range(n)]
    return prompts, budgets


def _stats(st):
    """Every counter of JAX's ScheduleStats, plus the derived ticks."""
    return {**{k: getattr(st, k) for k in _STAT_COUNTERS}, "ticks": st.ticks}


def _norm(outs):
    return [dataclasses.astuple(o) if isinstance(o, (ShedResult, JaxShed))
            else o for o in outs]


def serve_both(engines, pool, prompts, budgets, **kw):
    """Serve one trace through both schedulers; assert identical outputs,
    ShedResults and counters. Returns the port's (outputs, scheduler)."""
    jeng, teng = engines[pool]
    want, jsched = jeng.serve(prompts, budgets, return_scheduler=True, **kw)
    got, sched = teng.serve(prompts, budgets, return_scheduler=True, **kw)
    assert _norm(got) == _norm(want)
    assert _stats(sched.stats) == _stats(jsched.stats)
    assert sched.stats.counters_line() == jsched.stats.counters_line()
    assert sched.completed_at == jsched.completed_at
    if sched.pool.paged:
        alloc = sched.pool.alloc
        alloc.check()
        assert alloc.free_pages == alloc.usable_pages
        assert sched.pool.pages_allocated == sched.pool.pages_freed \
            == jsched.pool.pages_allocated
    return got, sched


def _static(engines, prompts, budgets):
    return engines["dense-mono"][1].serve_static(prompts, budgets,
                                                 max_batch=4)


# ---------------------------------------------------------------------------
# preemption: evict, requeue, resume from the snapshot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool", list(POOLS))
def test_preempt_resume_as_in_jax(engines, pool):
    """Low-priority requests run first; strictly more urgent arrivals
    displace them mid-stream (mid-prompt too, under chunked admission)."""
    prompts, budgets = _requests(8, seed=21)
    out, sched = serve_both(
        engines, pool, prompts, budgets, max_batch=2,
        priorities=[3, 3, 2, 2, 1, 1, 0, 0],
        arrival_chunks=[0, 0, 1, 1, 2, 2, 3, 3])
    assert sched.stats.preemptions > 0
    assert sched.stats.snapshots == sched.stats.preemptions
    if pool.startswith("dense"):
        assert out == _static(engines, prompts, budgets)


@pytest.mark.parametrize("pool", ["dense-mono", "paged-int8"])
def test_one_slot_pool_preemption(engines, pool):
    """One slot: every more urgent arrival preempts THE slot; the victim
    bounces back and forth and still finishes."""
    prompts, budgets = _requests(4, seed=23)
    out, sched = serve_both(engines, pool, prompts, budgets, max_batch=1,
                            priorities=[2, 1, 1, 0],
                            arrival_chunks=[0, 1, 2, 3])
    assert sched.stats.preemptions > 0
    if pool == "dense-mono":
        assert out == _static(engines, prompts, budgets)


@pytest.mark.parametrize("pool", ["dense-mono", "dense-chunked"])
def test_equal_priority_never_preempts(engines, pool):
    prompts, budgets = _requests(6, seed=27)
    out, sched = serve_both(engines, pool, prompts, budgets, max_batch=2,
                            priorities=[1] * 6,
                            arrival_chunks=[0, 0, 1, 2, 3, 4])
    assert sched.stats.preemptions == 0
    assert out == _static(engines, prompts, budgets)


# ---------------------------------------------------------------------------
# EDF order, the bounded queue, deadlines
# ---------------------------------------------------------------------------


def _completion_order(eng, prompts, budgets, **kw):
    done = []
    eng.serve(prompts, budgets, on_complete=lambda rid, _: done.append(rid),
              **kw)
    return done


@pytest.mark.parametrize("kw,first", [
    (dict(priorities=[2, 0, 1, 0]), [1, 3, 2, 0]),
    (dict(deadlines=[None, 50, 200, None]), [1]),
    (dict(priorities=[1, 1, 0, 1], deadlines=[30, 20, None, None]), [2, 1]),
])
def test_edf_order_as_in_jax(engines, kw, first):
    """One slot, simultaneous arrivals: admission follows the priority
    class, then the earliest deadline, then submission order."""
    prompts, budgets = _requests(4, seed=31)
    jeng, teng = engines["dense-mono"]
    got = _completion_order(teng, prompts, budgets, max_batch=1, **kw)
    assert got == _completion_order(jeng, prompts, budgets, max_batch=1,
                                    **kw)
    assert got[:len(first)] == first
    serve_both(engines, "dense-mono", prompts, budgets, max_batch=1, **kw)


@pytest.mark.parametrize("pool", ["dense-mono", "paged-int8"])
def test_bounded_queue_sheds_least_urgent(engines, pool):
    """Submissions past max_queue shed the least valued entry known at
    submit time, never the most urgent class."""
    prompts, budgets = _requests(8, seed=35)
    out, sched = serve_both(engines, pool, prompts, budgets, max_batch=2,
                            max_queue=3,
                            priorities=[0, 0, 1, 1, 2, 2, 2, 2])
    shed = [o for o in out if isinstance(o, ShedResult)]
    assert shed and sched.stats.sheds == len(shed)
    assert all(o.reason == "queue_full" and o.priority >= 1 for o in shed)


@pytest.mark.parametrize("pool", ["dense-mono", "dense-chunked"])
def test_infeasible_deadlines_shed(engines, pool):
    """A deadline even the optimistic estimate cannot meet is shed at
    admission (deadline_infeasible), at the tick it is found."""
    prompts, budgets = _requests(8, seed=37)
    out, sched = serve_both(engines, pool, prompts, budgets, max_batch=2,
                            deadlines=[None, 0, 6, 6, 8, 9, 12, None],
                            arrival_chunks=[0, 0, 0, 1, 1, 2, 2, 3])
    shed = [o for o in out if isinstance(o, ShedResult)]
    assert any(o.rid == 1 and o.reason == "deadline_infeasible"
               for o in shed)


def test_page_stall_counts_deadline_miss(engines):
    """A prefill stalled for pages while a neighbour decodes: admitted on
    time by the optimistic estimate (2 prefill rounds + 5 decode chunks =
    deadline 7), it waits two rounds for the pages of the more urgent
    request (deadline 4) and completes at tick 8: one deadline miss, as in
    JAX."""
    rng = np.random.default_rng(43)
    prompts = [list(map(int, rng.integers(4, 512, n))) for n in (48, 64)]
    out, sched = serve_both(engines, "paged-tight", prompts, [6, 17],
                            max_batch=2, deadlines=[4, 7])
    assert sched.stats.deadline_misses == 1
    assert sched.completed_at[1] == 8
    assert all(isinstance(o, list) for o in out)


@pytest.mark.parametrize("pool", ["paged-tight", "dense-mono"])
def test_page_pressure_with_priorities(engines, pool):
    """Priority preemption and page pressure together: the same victims,
    snapshots and restores as in JAX."""
    prompts, budgets = _requests(8, seed=45)
    out, sched = serve_both(engines, pool, prompts, budgets, max_batch=3,
                            priorities=[2, 2, 1, 1, 0, 0, 0, 1],
                            arrival_chunks=[0, 0, 0, 0, 1, 1, 2, 2])
    assert sched.stats.preemptions > 0


def test_generous_deadlines_never_missed(engines):
    prompts, budgets = _requests(4, seed=39)
    out, sched = serve_both(engines, "dense-mono", prompts, budgets,
                            max_batch=4, deadlines=[1000] * 4)
    assert sched.stats.deadline_misses == 0 and sched.stats.sheds == 0
    assert out == _static(engines, prompts, budgets)


def test_counters_line_mentions_every_counter(engines):
    from repro_torch.serving import Scheduler
    line = Scheduler(engines["dense-mono"][1], max_batch=1) \
        .stats.counters_line()
    for name in ("preemptions", "sheds", "deadline_misses", "retries",
                 "quarantines", "snapshot_corruptions", "page_preemptions"):
        assert f"{name}=0" in line


def test_serve_knob_validation_as_in_jax(engines):
    """The serve knobs' length checks and Request's field checks raise
    JAX's ValueErrors, in JAX's words."""
    jeng, teng = engines["dense-mono"]
    prompts, budgets = _requests(2, seed=41)
    for kw in (dict(priorities=[0]), dict(deadlines=[1, 2, 3]),
               dict(arrival_chunks=[0]), dict(deadlines=[None, -1]),
               dict(arrival_chunks=[0, -2])):
        with pytest.raises(ValueError) as jerr:
            jeng.serve(prompts, budgets, **kw)
        with pytest.raises(ValueError) as terr:
            teng.serve(prompts, budgets, **kw)
        assert str(terr.value) == str(jerr.value)

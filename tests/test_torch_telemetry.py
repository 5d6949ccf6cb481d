"""Telemetry of the PyTorch port against the JAX package's, on the CPU.

The plain layers (`Tracer`, `MetricsRegistry`, `percentile_from_cumulative`,
`ServingTimelines`, the `Telemetry` facade) are driven with the same
operations and one injected fake clock in both packages and must export
the same bytes. `plan_attribution` must equal JAX's record for all eleven
configs. A SMOKE overload serve in fp32 (bridged weights; a bounded queue,
priorities, deadlines, preemption with snapshot and restore, both shed
reasons) must give the same stamps per request (event, tick, fields), the
same counter, gauge and tick-histogram records, the same counts in the
wall-clock histograms and the same spans as JAX's, an export that
`scripts/check_trace.py` accepts, and with telemetry off the same tokens,
ShedResults and counters. Two Trainer steps must give JAX's step records
(loss, grad norm, lr within 1e-5 relative), counters and attribution; the
serve launcher's --trace-out and --metrics-out must write loadable files."""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import telemetry as jtel
from repro.configs import ALL_IDS
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as jmodel
from repro.parallel.plan import resolve_attention_plan as jax_plan
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.serving.engine import ServingEngine as JaxEngine
from repro.train import Trainer as JaxTrainer

from repro_torch import telemetry as ttel
from repro_torch.checkpoint import bridge
from repro_torch.configs import config_from_dict
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.data.pipeline import DataState
from repro_torch.models.transformer import flatten
from repro_torch.optim import adamw_init
from repro_torch.parallel.plan import resolve_attention_plan as port_plan
from repro_torch.serving import ServingEngine, ShedResult
from repro_torch.serving.scheduler import _STAT_COUNTERS
from repro_torch.telemetry import trace as ttrace
from repro_torch.train import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": jtel, "port": ttel}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port while this module runs: its
    SMOKE-sized ops gain nothing from more, and under the test run's
    parallel workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    """A deterministic perf_counter_ns: each read advances by a step that
    cycles through odd sizes, so rounding to 3 decimals is exercised."""

    def __init__(self):
        self.t = 10_000_000
        self.i = 0

    def __call__(self):
        self.i += 1
        self.t += 1_234 + 977 * (self.i % 5)
        return self.t


def _drive_tracer(tel, capacity):
    tr = tel.Tracer(capacity=capacity, clock=FakeClock())
    with tr.span("outer", cat="test", run=1):
        with tr.span("inner") as sp:
            sp.annotate(rows=3)
            sp.annotate(rows=4, extra="x")
        tr.instant("marker", cat="test", tick=0)
        for i in range(6):
            with tr.span(f"loop{i % 2}", cat="loop", i=i):
                tr.instant(f"e{i}")
    tr.instant("bare")
    return tr


def _bridged(params_j, cfg_t):
    flat = {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params_j)[0]}
    return bridge.params_from_flat(flat, cfg_t, device="cpu")


# -- the plain layers ---------------------------------------------------------


@pytest.mark.parametrize("capacity", [1 << 16, 8, 1])
def test_tracer_sequences_equal_jax(capacity, tmp_path):
    """Spans, nested spans, annotations, instants and ring overflow: the
    same chrome events, drop count and trace file bytes."""
    got = _drive_tracer(ttel, capacity)
    want = _drive_tracer(jtel, capacity)
    assert got.chrome_events() == want.chrome_events()
    assert got.dropped == want.dropped
    assert got.dropped == max(0, 16 - capacity)
    files = {}
    for name, tr in (("port", got), ("jax", want)):
        path = PKGS[name].write_chrome_trace(
            str(tmp_path / f"{name}.json"), tr.chrome_events(),
            metadata={"dropped_events": tr.dropped})
        files[name] = open(path).read()
    assert files["port"] == files["jax"]


def test_disabled_tracer_makes_nothing():
    """A disabled tracer reads no clock, and hands out the one null span."""
    reads = []
    tr = ttel.Tracer(enabled=False, clock=lambda: reads.append(1) or 0)
    assert tr.span("a") is tr.span("b") is ttrace._NULL_SPAN
    with tr.span("x") as sp:
        sp.annotate(ignored=1)
    tr.instant("y")
    assert reads == [] and tr.events() == [] and tr.dropped == 0


def _drive_registry(tel):
    reg = tel.MetricsRegistry()
    reg.counter("reqs_total", priority="0").inc(3)
    reg.counter("reqs_total", priority="1").inc()
    reg.counter("reqs_total", priority="0").inc(0.5)
    reg.gauge("pages_in_use").set(7)
    reg.gauge("pages_in_use").set(5.25)
    h = reg.histogram("lat_ms", priority="0")
    for v in (0.2, 0.7, 3, 3, 12, 80, 400, 9000):
        h.observe(v)
    t = reg.histogram("ticks", buckets=tel.TICK_BUCKETS, reason="a b")
    for v in (0, 1, 1, 5, 300):
        t.observe(v)
    reg.histogram("empty", buckets=(1, 2))
    reg.histogram("custom", buckets=(3, 1, 2), x="y").observe(2.5)
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("reqs_total")
    return reg


def test_registry_exports_equal_jax():
    got, want = _drive_registry(ttel), _drive_registry(jtel)
    assert got.prometheus_text() == want.prometheus_text()
    assert got.jsonl_text() == want.jsonl_text()
    assert got.jsonl_records() == want.jsonl_records()
    assert got.histogram("lat_ms", priority="0").percentile(90) == \
        want.histogram("lat_ms", priority="0").percentile(90)


def _cumulative_grid():
    rng = np.random.default_rng(0)
    grids = [[], [(1.0, 0), (math.inf, 0)]]
    for n in (1, 3, 10):
        bs = sorted(set(float(b) for b in rng.integers(1, 50, n)))
        counts = rng.integers(0, 5, len(bs) + 1)
        acc, cum = 0, []
        for le, c in zip(bs + [math.inf], counts):
            acc += int(c)
            cum.append((le, acc))
        grids.append(cum)
    return grids


def test_percentile_from_cumulative_equals_jax():
    for cum in _cumulative_grid():
        total = cum[-1][1] if cum else 0
        for p in (0, 1, 25, 50, 90, 99, 100):
            for lo, hi in ((math.inf, -math.inf), (0.5, 60.0), (2.0, 2.0)):
                a = ttel.percentile_from_cumulative(cum, total, p, lo, hi)
                b = jtel.percentile_from_cumulative(cum, total, p, lo, hi)
                assert (math.isnan(a) and math.isnan(b)) or a == b, \
                    (cum, p, lo, hi, a, b)


# every lifecycle event the scheduler stamps, across three requests
STAMPS = [
    (0, "queued", 0, dict(priority=2, deadline=8, prompt_len=24,
                          budget=8)),
    (1, "queued", 0, dict(priority=0, deadline=6, prompt_len=8, budget=4)),
    (2, "queued", 1, dict(priority=1, deadline=2, prompt_len=8, budget=16)),
    (0, "admitted", 0, dict(row=0)),
    (0, "prefill_chunk", 0, dict(filled=16, total=24)),
    (0, "prefill_chunk", 0, dict(filled=24, total=24)),
    (0, "first_token", 0, {}),
    (2, "shed", 1, dict(reason="deadline_infeasible")),
    (0, "snapshot", 2, dict(row=0)),
    (0, "preempted", 2, dict(row=0)),
    (1, "admitted", 2, dict(row=0)),
    (1, "first_token", 2, {}),
    (1, "retired", 3, dict(n_tokens=4)),
    (0, "restored", 3, dict(row=0)),
    (0, "quarantined", 4, dict(row=0, retries=1)),
    (0, "restored", 5, dict(row=1)),
    (0, "deadline_miss", 9, dict(deadline=8)),
    (0, "retired", 9, dict(n_tokens=8)),
]


def _drive_timelines(tel):
    tr = tel.Tracer(clock=FakeClock())
    tl = tel.ServingTimelines(tr)
    for rid, ev, tick, fields in STAMPS:
        tl.stamp(rid, ev, tick, **fields)
    reg = tel.MetricsRegistry()
    tl.finalize(reg)
    return tr, tl, reg


def test_timelines_finalize_and_lanes_equal_jax():
    (tr_t, tl_t, reg_t), (tr_j, tl_j, reg_j) = (_drive_timelines(ttel),
                                                _drive_timelines(jtel))
    assert [tl_t.stamps(r) for r in tl_t.rids()] == \
        [tl_j.stamps(r) for r in tl_j.rids()]
    assert reg_t.jsonl_records() == reg_j.jsonl_records()
    assert reg_t.prometheus_text() == reg_j.prometheus_text()
    assert tl_t.trace_events(pid=101, run_label="serving#1") == \
        tl_j.trace_events(pid=101, run_label="serving#1")
    assert tr_t.chrome_events() == tr_j.chrome_events()
    names = {r["metric"] for r in reg_t.jsonl_records()}
    assert {"serving_ttft_ms", "serving_tpot_ms", "serving_queue_wait_ticks",
            "serving_deadline_slack_ticks", "serving_deadline_miss_total",
            "serving_shed_events_total", "serving_preempted_events_total",
            "serving_quarantined_events_total"} <= names


def _drive_facade(tel):
    fac = tel.Telemetry()
    fac.tracer = tel.Tracer(clock=FakeClock())
    with fac.span("serve", cat="engine", n_requests=2):
        fac.instant("tick", cat="event", n=1)
    fac.record("plan_attribution", backend="fused")
    fac.metrics.counter("serving_compile_cache_miss_total",
                        fn="prefill").inc()
    for run in range(2):
        tl = fac.new_timelines("serving")
        reg = tel.MetricsRegistry()
        fac.adopt_registry(reg, "serving")
        tl.stamp(0, "queued", 0, priority=0, deadline=None)
        tl.stamp(0, "admitted", run, row=0)
        tl.stamp(0, "first_token", run + 1)
        tl.stamp(0, "retired", run + 3, n_tokens=3)
        reg.counter("serving_chunks_total").inc(run + 2)
        tl.finalize(reg)
    fac.adopt_registry(tel.MetricsRegistry(), "train")
    return fac


def test_facade_exports_equal_jax(tmp_path):
    got, want = _drive_facade(ttel), _drive_facade(jtel)
    assert got.chrome_events() == want.chrome_events()
    assert got.metrics_records() == want.metrics_records()
    assert got.prometheus_text() == want.prometheus_text()
    for name, fac in (("port", got), ("jax", want)):
        fac.export_trace(str(tmp_path / f"{name}.json"),
                         metadata={"arch": "x"})
        fac.export_metrics_jsonl(str(tmp_path / f"{name}.jsonl"))
    for ext in ("json", "jsonl"):
        assert (tmp_path / f"port.{ext}").read_text() == \
            (tmp_path / f"jax.{ext}").read_text()
    assert ttel.RUN_PID_BASE == jtel.RUN_PID_BASE
    assert ttel.HOST_PID == jtel.HOST_PID


def test_disabled_facade_hands_out_the_shared_nulls(tmp_path):
    off = ttel.Telemetry(enabled=False)
    assert ttel.as_telemetry(None) is ttel.NULL_TELEMETRY
    assert not ttel.NULL_TELEMETRY.enabled
    for fac in (off, ttel.NULL_TELEMETRY):
        assert fac.span("a") is ttrace._NULL_SPAN
        assert fac.new_timelines() is ttel.NULL_TIMELINES
        fac.record("x", a=1)
        fac.instant("y")
        fac.adopt_registry(ttel.MetricsRegistry())
        assert fac.records == [] and fac.metrics_records() == []
        assert fac.chrome_events() == jtel.Telemetry(
            enabled=False).chrome_events()
    ttel.NULL_TIMELINES.stamp(0, "queued", 0, priority=0)
    ttel.NULL_TIMELINES.finalize(ttel.MetricsRegistry())
    assert not ttel.NULL_TIMELINES.enabled
    assert ttel.as_telemetry(off) is off


# -- plan attribution ---------------------------------------------------------


@pytest.mark.parametrize("chunk", [None, 2])
@pytest.mark.parametrize("arch", ALL_IDS)
def test_plan_attribution_equals_jax(arch, chunk):
    """Every config at SMOKE, with and without a prefill chunk (in blocks),
    at two batch sizes: the port's record equals JAX's key for key."""
    cfg_j = jax_smoke_config(arch)
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    c = cfg_j.attention.linformer.block_size
    for batch, max_seq in ((1, 256), (2, 16 * c)):
        kw = dict(max_seq=max_seq, batch=batch,
                  prefill_chunk=chunk and chunk * c)
        got = ttel.plan_attribution(port_plan(cfg_t.attention),
                                    cfg_t.attention, **kw)
        want = jtel.plan_attribution(jax_plan(cfg_j.attention),
                                     cfg_j.attention, **kw)
        assert json.dumps(got, sort_keys=True) == \
            json.dumps(want, sort_keys=True)


@pytest.mark.parametrize("backend", ["auto", "fused", "reference"])
@pytest.mark.parametrize("backward", ["fused", "reference"])
def test_plan_attribution_resolves_the_knobs_as_jax(backend, backward):
    cfg_j = jax_smoke_config("qwen3-8b").with_attention_backend(backend) \
        .with_backward_impl(backward)
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    got = ttel.plan_attribution(port_plan(cfg_t.attention), cfg_t.attention,
                                max_seq=256, prefill_chunk=32)
    want = jtel.plan_attribution(jax_plan(cfg_j.attention), cfg_j.attention,
                                 max_seq=256, prefill_chunk=32)
    assert got == want
    assert got["backend"] == want["backend"]


# -- a SMOKE overload serve ---------------------------------------------------


def overload_trace(seed=0):
    """JAX's quick overload trace (benchmarks/serving_throughput.py
    `_overload_trace`) at qwen3-8b SMOKE's block of 16: a backlog of 12
    priority-2 requests oversubscribing a 4-row pool, priority-0 arrivals
    at ticks 2/4/6/8 with deadlines 4 ticks out, which preempt their way
    in, two priority-1 requests whose deadline 2 their budget cannot meet
    (shed as deadline_infeasible), and a queue bounded at 10 (part of the
    backlog shed as queue_full)."""
    rng = np.random.default_rng(seed)
    prompts, budgets, arrivals, prios, deadlines = [], [], [], [], []
    for _ in range(12):
        prompts.append(list(map(int, rng.integers(
            4, 512, int(rng.choice([8, 16, 24]))))))
        budgets.append(16)
        arrivals.append(0)
        prios.append(2)
        deadlines.append(None)
    for a in (2, 4, 6, 8):
        prompts.append(list(map(int, rng.integers(4, 512, 8))))
        budgets.append(4)
        arrivals.append(a)
        prios.append(0)
        deadlines.append(a + 4)
    for _ in range(2):
        prompts.append(list(map(int, rng.integers(4, 512, 8))))
        budgets.append(16)
        arrivals.append(1)
        prios.append(1)
        deadlines.append(2)
    return prompts, budgets, dict(arrival_chunks=arrivals, priorities=prios,
                                  deadlines=deadlines, max_queue=10,
                                  max_batch=4)


OVERLOAD_SEED = 3           # weights: no request ends early on EOS
OVERLOAD_POOLS = {
    "paged-chunked": dict(prefill_chunk=32, cache_format="paged"),
    "dense-mono": dict(),
}


def _norm(outs):
    return [dataclasses.astuple(o) if dataclasses.is_dataclass(o) else o
            for o in outs]


@pytest.fixture(scope="module", params=list(OVERLOAD_POOLS))
def overload(request):
    """One JAX serve with telemetry, one port serve with telemetry and one
    without, of the overload trace on `request.param`'s pool."""
    cfg_j = dataclasses.replace(jax_smoke_config("qwen3-8b"),
                                dtype="float32")
    params_j = jmodel.init_params(jax.random.PRNGKey(OVERLOAD_SEED), cfg_j)
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    params_t = _bridged(params_j, cfg_t)
    prompts, budgets, kw = overload_trace()
    ekw = dict(max_seq=64, decode_chunk=4, **OVERLOAD_POOLS[request.param])
    tel_j, tel_t = jtel.Telemetry(), ttel.Telemetry()
    jeng = JaxEngine(params_j, cfg_j, cache_dtype=jnp.float32,
                     telemetry=tel_j, **ekw)
    want, jsched = jeng.serve(prompts, budgets, return_scheduler=True, **kw)
    teng = ServingEngine(params_t, cfg_t, device="cpu",
                         cache_dtype=torch.float32, telemetry=tel_t, **ekw)
    got, sched = teng.serve(prompts, budgets, return_scheduler=True, **kw)
    off, sched_off = ServingEngine(
        params_t, cfg_t, device="cpu", cache_dtype=torch.float32,
        **ekw).serve(prompts, budgets, return_scheduler=True, **kw)
    return dict(pool=request.param, budgets=budgets, want=want,
                jsched=jsched, tel_j=tel_j, got=got, sched=sched,
                tel_t=tel_t, off=off, sched_off=sched_off)


def test_overload_serve_runs_every_leg(overload):
    """The trace is EOS-free and reaches every leg: both shed reasons,
    preemption with snapshot and restore, priority-0 requests on time."""
    got, sched = overload["got"], overload["sched"]
    assert _norm(got) == _norm(overload["want"])
    reasons = sorted(o.reason for o in got if isinstance(o, ShedResult))
    assert reasons.count("deadline_infeasible") == 2
    assert "queue_full" in reasons
    for o, b in zip(got, overload["budgets"]):
        assert isinstance(o, ShedResult) or len(o) == b
    assert sched.stats.preemptions > 0
    assert all(not isinstance(o, ShedResult) for o in got[12:16])
    events = {ev for r in sched.timelines.rids()
              for ev, _, _, _ in sched.timelines.stamps(r)}
    assert {"restored", "snapshot", "preempted", "first_token",
            "retired"} <= events


def test_overload_stamps_equal_jax(overload):
    """Every request's stamps, event, tick and fields, in order."""
    tl_t, tl_j = overload["sched"].timelines, overload["jsched"].timelines
    assert tl_t.rids() == tl_j.rids()
    for rid in tl_t.rids():
        got = [(e, t, f) for e, t, _, f in tl_t.stamps(rid)]
        want = [(e, t, f) for e, t, _, f in tl_j.stamps(rid)]
        assert got == want, rid
        assert all(t_us is not None for _, _, t_us, _ in tl_t.stamps(rid))


def _split_records(records):
    """(records compared exactly, {ms histogram key: count}). JAX's tuning
    table counters wait for the port's autotuner."""
    exact, ms = [], {}
    for r in records:
        if r.get("metric", "").startswith("tuning_table_"):
            continue
        if r.get("metric", "").endswith("_ms"):
            ms[(r["metric"], json.dumps(r["labels"], sort_keys=True),
                r.get("run"))] = r["count"]
        else:
            exact.append(r)
    return exact, ms


def test_overload_metrics_equal_jax(overload):
    """Counters, gauges, tick histograms, the plan attribution and the
    compile-cache counters equal; the wall-clock histograms' counts
    equal."""
    got = _split_records(overload["tel_t"].metrics_records())
    want = _split_records(overload["tel_j"].metrics_records())
    assert got[0] == want[0]
    assert got[1] == want[1] and got[1]
    kinds = {r.get("metric", r.get("kind")) for r in got[0]}
    assert {"plan_attribution", "serving_chunks_total",
            "serving_ttft_ticks", "serving_queue_wait_ticks",
            "serving_shed_events_total",
            "serving_compile_cache_miss_total"} <= kinds
    if overload["pool"].startswith("paged"):
        assert {"serving_pages_in_use", "serving_pages_free",
                "serving_quant_error_bound_sum"} <= kinds


def _span_counts(tel):
    counts = {}
    for e in tel.tracer.chrome_events():
        if e["ph"] == "X":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts


def test_overload_spans_equal_jax(overload):
    got = _span_counts(overload["tel_t"])
    assert got == _span_counts(overload["tel_j"])
    assert got["serve"] == 1
    assert got["decode_chunk"] == overload["sched"].stats.chunks
    if overload["pool"].startswith("paged"):
        assert got["prefill_chunk_forward"] > 0
        assert got["prefill_remainder_forward"] > 0
    else:
        assert got["admission_prefill"] > 0
    assert overload["tel_t"].tracer.dropped == 0


def test_overload_export_passes_check_trace(overload, tmp_path):
    tel = overload["tel_t"]
    trace = tel.export_trace(str(tmp_path / "trace.json"),
                             metadata={"arch": "qwen3-8b"})
    metrics = tel.export_metrics_jsonl(str(tmp_path / "metrics.jsonl"))
    res = subprocess.run([sys.executable,
                          os.path.join(ROOT, "scripts", "check_trace.py"),
                          trace, metrics], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    doc = json.load(open(trace))
    assert doc["metadata"]["dropped_events"] == 0


def test_overload_telemetry_off_changes_nothing(overload):
    """Telemetry on and off: the same tokens, ShedResults, counters,
    completion ticks and chunks; off, the run registry holds only the
    scheduler's counters (and page gauges) and no stamp."""
    sched, off = overload["sched"], overload["sched_off"]
    assert _norm(overload["off"]) == _norm(overload["got"])
    assert off.stats.counter_records() == sched.stats.counter_records()
    assert [r["metric"] for r in off.stats.counter_records()] == \
        sorted(_STAT_COUNTERS.values())
    assert off.stats.chunks == sched.stats.chunks
    assert off.completed_at == sched.completed_at
    assert off.timelines is ttel.NULL_TIMELINES
    assert off.telemetry is ttel.NULL_TELEMETRY
    assert not any(r["type"] == "histogram"
                   for r in off.stats.registry.jsonl_records())


# -- the launcher -------------------------------------------------------------


def test_launcher_writes_trace_and_metrics(tmp_path):
    from repro_torch.launch import serve as tserve
    trace, metrics = tmp_path / "t.json", tmp_path / "m.jsonl"
    tserve.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
                 "--requests", "4", "--max-new-tokens", "4",
                 "--max-batch", "2", "--trace-out", str(trace),
                 "--metrics-out", str(metrics)])
    doc = json.load(open(trace))
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"serve", "decode_chunk"} <= names
    assert doc["metadata"] == {"dropped_events": 0, "arch": "qwen3-8b",
                               "scheduler": "continuous"}
    recs = [json.loads(line) for line in open(metrics)]
    assert any(r.get("kind") == "plan_attribution" for r in recs)
    assert any(r.get("metric") == "serving_ttft_ticks" for r in recs)


# -- the Trainer --------------------------------------------------------------


def test_trainer_records_equal_jax(tmp_path):
    """Two SMOKE fp32 steps from the same weights and batches: the
    train_step records' loss, grad norm and lr within 1e-5 relative, the
    step and token counters, the gauges' presence, the plan attribution
    and the spans as JAX's."""
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    tkw = dict(seq_len=32, global_batch=2, steps=2, log_every=100)
    cfg_j = dataclasses.replace(jax_smoke_config("qwen3-8b"),
                                dtype="float32")
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    tel_j, tel_t = jtel.Telemetry(), ttel.Telemetry()
    jtr = JaxTrainer(cfg_j, JTrainConfig(
        checkpoint_every=100, checkpoint_dir=str(tmp_path / "j"),
        optimizer=JOptimizerConfig(**opt), **tkw),
        log_fn=lambda s: None, telemetry=tel_j)
    params_j = jtr.init_state()[0]
    jtr.run()
    tr = Trainer(cfg_t, TrainConfig(checkpoint_every=0,
                                    optimizer=OptimizerConfig(**opt), **tkw),
                 device="cpu", log_fn=lambda s: None, telemetry=tel_t)

    def init_state():
        params = _bridged(params_j, cfg_t)
        for p in flatten(params).values():
            p.requires_grad_(True)
        return (params, adamw_init(params, tr.tcfg.optimizer),
                DataState(tr.tcfg.seed, 0))

    tr.init_state = init_state
    tr.run()
    got = [r for r in tel_t.records if r["kind"] == "train_step"]
    want = [r for r in tel_j.records if r["kind"] == "train_step"]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1]
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
        assert set(g) == set(w)
    for g, h in zip(got, tr.history):
        assert g["step_ms"] == round(h["ms"], 3) and g["loss"] == h["loss"]
    attr = [[r for r in tel.records if r["kind"] == "plan_attribution"]
            for tel in (tel_t, tel_j)]
    assert attr[0] == attr[1] and len(attr[0]) == 1
    for name in ("train_steps_total", "train_tokens_total"):
        assert tel_t.metrics.counter(name).value == \
            tel_j.metrics.counter(name).value
    assert tel_t.metrics.histogram("train_step_ms").count == 2
    for name in ("train_loss", "train_grad_norm"):
        np.testing.assert_allclose(tel_t.metrics.gauge(name).value,
                                   tel_j.metrics.gauge(name).value,
                                   rtol=1e-5)
    assert _span_counts(tel_t) == _span_counts(tel_j) == {"train_step": 2}

"""The port's tuning table and autotuner against the JAX package's, on the
CPU.

The table functions are copies: bucketing, the schema check's findings on
a battery of broken documents, the most-specific and file-order lookups,
`override` and the hit/miss stats equal JAX's exactly. The sweep with one
injected timer (no real timing) gives JAX's entries and trial labels for
the forms both packages tune; the port has no exact-form sweep (its
kernels 5 and 6 take no runtime tile). The serving engine's
`decode_chunk=None` resolves through the table as JAX's does and serves
JAX's tokens and ticks. The committed ``TUNING_TORCH.json`` holds card
entries only, so on the CPU every lookup misses."""
import copy
import dataclasses
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as jmodel
from repro.serving.engine import ServingEngine as JaxEngine
from repro.telemetry import Telemetry as JTelemetry
from repro.tune import autotune as jauto
from repro.tune import table as jtable

from repro_torch.checkpoint import bridge
from repro_torch.configs import config_from_dict
from repro_torch.serving import ServingEngine
from repro_torch.telemetry import Telemetry
from repro_torch.tune import autotune as tauto
from repro_torch.tune import table as ttable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's SMOKE-sized ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SETUPS = {tauto: {}, jauto: {}}


@pytest.fixture
def cached_setups(monkeypatch):
    """Under an injected timer no trial runs, so the inputs and models the
    sweeps build are never read: both sweeps' `_serving_setup` is memoized
    per argument set (across tests) and, within the test, JAX's random
    draws are zeros (each draw of a new shape would compile), which keeps
    the module fast."""
    monkeypatch.setattr(
        jax.random, "normal",
        lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    for mod, memo in _SETUPS.items():
        real = mod._serving_setup

        def setup(*a, _memo=memo, _real=real, **kw):
            key = (a, tuple(sorted(kw.items(), key=str)))
            if key not in _memo:
                _memo[key] = _real(*a, **kw)
            return _memo[key]

        monkeypatch.setattr(mod, "_serving_setup", setup)


def _entry(**kw):
    e = dict(platform="cpu", form="causal_chunked", bucket={"seq": 64},
             params={"q_chunk_blocks": 2}, trial_us=1.0, default_us=2.0,
             speedup=2.0, trials=3)
    e.update(kw)
    return e


def _doc(*entries, **top):
    return {"version": 1, "entries": list(entries), **top}


# a battery of documents, valid and broken at every check of validate_doc
DOCS = [
    _doc(_entry()),
    _doc(),
    [], "TUNING", None, 3,
    {"entries": []},
    _doc(version=2),
    {"version": 1},
    {"version": 1, "entries": {"a": 1}},
    _doc("entry"),
    _doc(_entry(platform="")),
    _doc(_entry(platform=7)),
    _doc({k: v for k, v in _entry().items() if k != "platform"}),
    _doc(_entry(form="fused")),
    _doc(_entry(params={})),
    _doc(_entry(params=None)),
    _doc(_entry(params={"block_q": 64})),
    _doc(_entry(params={"q_chunk_blocks": 0})),
    _doc(_entry(params={"q_chunk_blocks": True})),
    _doc(_entry(params={"q_chunk_blocks": 2.0})),
    _doc(_entry(form="scalars", bucket={"seq": 64},
                params={"decode_chunk": 8})),
    _doc(_entry(form="scalars", bucket=None, params={"decode_chunk": 8,
                                                     "prefill_chunk": 64,
                                                     "chunked_min_seq": 1})),
    _doc(_entry(bucket=None)),
    _doc(_entry(bucket={})),
    _doc(_entry(bucket={"seq": 64, "rows": 2})),
    _doc(_entry(bucket={"seq": 96})),
    _doc(_entry(bucket={"seq": True})),
    _doc(_entry(bucket={"slots": 0})),
    _doc(_entry(form="exact", params={"block_q": 64, "block_s": 128},
                bucket={"seq": 64, "slots": 16, "heads": 3,
                        "dtype": "float32"})),
    _doc(_entry(form="exact", params={"block_q": 64},
                bucket={"heads": "4", "dtype": 32})),
    _doc(_entry(trial_us=0)),
    _doc(_entry(default_us=-1.0)),
    _doc(_entry(trial_us=True)),
    _doc({k: v for k, v in _entry().items() if k != "default_us"}),
    _doc(_entry(trials=0)),
    _doc(_entry(trials=2.5)),
    _doc(_entry(), _entry(form="x"), _entry(trials=None), generated_by="t"),
]


def test_bucketing_equals_jax():
    for n in list(range(1, 70)) + [127, 128, 129, 4095, 4096, 4097, 65536]:
        assert ttable.next_pow2(n) == jtable.next_pow2(n)
    for bad in (0, -3):
        with pytest.raises(ValueError) as a:
            ttable.next_pow2(bad)
        with pytest.raises(ValueError) as b:
            jtable.next_pow2(bad)
        assert str(a.value) == str(b.value)
    for kw in ({}, {"seq": 100}, {"slots": 17, "heads": 4},
               {"seq": 2048, "slots": 128, "heads": 3, "dtype": "bfloat16"},
               {"dtype": "float32"}):
        assert ttable.shape_bucket(**kw) == jtable.shape_bucket(**kw)
    assert ttable.TUNABLE_PARAMS == jtable.TUNABLE_PARAMS
    assert ttable.BUCKET_KEYS == jtable.BUCKET_KEYS
    assert ttable.TABLE_VERSION == jtable.TABLE_VERSION


@pytest.mark.parametrize("i", range(len(DOCS)))
def test_validate_doc_findings_equal_jax(i):
    doc = DOCS[i]
    assert ttable.validate_doc(copy.deepcopy(doc)) == \
        jtable.validate_doc(copy.deepcopy(doc))


def _pair(entries):
    return (ttable.TuningTable(copy.deepcopy(entries)),
            jtable.TuningTable(copy.deepcopy(entries)))


LOOKUP_ENTRIES = [
    _entry(form="exact", bucket={"seq": 512}, params={"block_q": 32}),
    _entry(form="exact", bucket={"seq": 512, "heads": 4},
           params={"block_q": 64}),
    _entry(form="exact", bucket={"seq": 512, "heads": 4},
           params={"block_q": 128}),
    _entry(form="exact", bucket={"seq": 1024, "slots": 128, "heads": 4,
                                 "dtype": "float32"},
           params={"block_q": 256, "block_s": 512}),
    _entry(platform="tpu", form="exact", bucket={"seq": 512},
           params={"block_q": 16}),
    _entry(bucket={"seq": 8192}, params={"q_chunk_blocks": 4}),
    _entry(form="scalars", bucket=None,
           params={"decode_chunk": 8, "chunked_min_seq": 2048}),
    _entry(form="scalars", bucket=None, params={"decode_chunk": 16}),
]
QUERIES = [
    ("exact", dict(seq=300)), ("exact", dict(seq=512, heads=4)),
    ("exact", dict(seq=400, heads=2)), ("exact", dict(seq=513, heads=4)),
    ("exact", dict(seq=1000, slots=100, heads=4, dtype="float32")),
    ("exact", dict(seq=1000, slots=100, heads=4, dtype="bfloat16")),
    ("exact", dict(seq=512, platform="tpu")),
    ("exact", dict(seq=512, platform="gpu")),
    ("causal_chunked", dict(seq=5000)), ("causal_chunked", dict(seq=9000)),
    ("causal_chunked", dict()), ("scalars", dict()),
    ("scalars", dict(platform="tpu")),
]


def test_lookups_and_stats_equal_jax():
    """Most-specific match, ties to the first in file order, platforms
    apart; the hit/miss stats and their drain equal JAX's."""
    tt, jt = _pair(LOOKUP_ENTRIES)
    ttable.consume_stats()
    jtable.consume_stats()
    for form, kw in QUERIES:
        kw = dict(kw)
        kw.setdefault("platform", "cpu")
        assert tt.lookup(form, **kw) == jt.lookup(form, **kw), (form, kw)
    for name, default in (("decode_chunk", 32), ("prefill_chunk", 0),
                          ("chunked_min_seq", 8192)):
        assert tt.scalar(name, default, platform="cpu") == \
            jt.scalar(name, default, platform="cpu")
    stats = ttable.consume_stats()
    assert stats == jtable.consume_stats() and stats["hits"] and \
        stats["misses"]
    assert ttable.consume_stats() == {"hits": 0, "misses": 0}


def test_typed_helpers_and_override_equal_jax():
    """The module helpers read the process table; override pins one (None:
    empty) and restores the previous on exit, nested too."""
    tt, jt = _pair(LOOKUP_ENTRIES)
    with ttable.override(tt), jtable.override(jt):
        assert ttable.get_table() is tt and jtable.get_table() is jt
        assert ttable.q_chunk_blocks_for(seq=8000, platform="cpu") == \
            jtable.q_chunk_blocks_for(seq=8000) == 4
        assert ttable.scalar("decode_chunk", 32, platform="cpu") == \
            jtable.scalar("decode_chunk", 32) == 8
        for fn in ("block_q_for", "block_s_for"):
            kw = dict(seq=1024, slots=128, heads=4, dtype="float32")
            assert getattr(ttable, fn)(platform="cpu", **kw) == \
                getattr(jtable, fn)(**kw)
        with ttable.override(None), jtable.override(None):
            assert ttable.scalar("decode_chunk", 32, platform="cpu") == \
                jtable.scalar("decode_chunk", 32) == 32
            assert ttable.q_chunk_blocks_for(seq=8000, platform="cpu") == \
                jtable.q_chunk_blocks_for(seq=8000) == 8
        assert ttable.get_table() is tt
    assert ttable.get_table() is not tt
    ttable.consume_stats()
    jtable.consume_stats()


def test_add_save_load_round_trip(tmp_path, monkeypatch):
    """add() rounds and derives speedup as JAX's; save() refuses an invalid
    table and writes JAX's bytes; load() of a missing, corrupt or invalid
    file is an empty table; the path variable is the port's own."""
    kw = dict(platform="cpu", form="scalars", bucket=None,
              params={"decode_chunk": 8}, trial_us=3.14159265,
              default_us=10.0, trials=5)
    tt, jt = ttable.TuningTable(meta={"mode": "smoke"}), \
        jtable.TuningTable(meta={"mode": "smoke"})
    tt.add(**kw)
    jt.add(**kw)
    assert tt.to_doc() == jt.to_doc()
    for t in (tt, jt):
        with pytest.raises(ValueError):
            t.add(**dict(kw, form="nope"))
        with pytest.raises(ValueError):
            t.add(**dict(kw, params={"block_q": 8}))
    pt, pj = tmp_path / "t.json", tmp_path / "j.json"
    tt.save(str(pt))
    jt.save(str(pj))
    assert pt.read_bytes() == pj.read_bytes()
    loaded = ttable.TuningTable.load(str(pt))
    assert loaded.entries == tt.entries and loaded.meta == {"mode": "smoke"}
    bad = ttable.TuningTable([dict(tt.entries[0], trials=0)])
    with pytest.raises(ValueError, match="invalid tuning table"):
        bad.save(str(tmp_path / "bad.json"))
    (tmp_path / "corrupt.json").write_text("{not json")
    (tmp_path / "schema.json").write_text(json.dumps({"version": 9}))
    for name in ("missing.json", "corrupt.json", "schema.json"):
        assert ttable.TuningTable.load(str(tmp_path / name)).entries == []
    assert ttable.ENV_PATH == "REPRO_TORCH_TUNING_PATH" != jtable.ENV_PATH
    monkeypatch.setenv(ttable.ENV_PATH, str(pt))
    ttable.clear_table_cache()
    try:
        assert ttable.get_table().entries == tt.entries
    finally:
        monkeypatch.delenv(ttable.ENV_PATH)
        ttable.clear_table_cache()
    assert os.path.basename(ttable.default_path()) == "TUNING_TORCH.json"
    assert ttable.platform_key("cpu") == ttable.platform_key(
        torch.device("cpu")) == "cpu"


def test_committed_table_is_valid_and_holds_card_entries_only():
    """TUNING_TORCH.json passes both packages' schema check; every entry is
    keyed on a card; its meta names the card, its power limit and the
    full mode. On the CPU every lookup therefore misses."""
    with open(os.path.join(ROOT, "TUNING_TORCH.json")) as fh:
        doc = json.load(fh)
    assert ttable.validate_doc(doc) == [] == jtable.validate_doc(doc)
    assert doc["entries"] and all(e["platform"].startswith("cuda:")
                                  for e in doc["entries"])
    assert doc["mode"] == "full" and "W" in doc["card"]
    assert {e["form"] for e in doc["entries"]} == {"causal_chunked",
                                                   "scalars"}
    table = ttable.TuningTable.load(os.path.join(ROOT, "TUNING_TORCH.json"))
    assert table.lookup("scalars", platform="cpu") == {}


def _timer(salt):
    """A fixed timer per label: µs from a hash of (salt, label)."""
    labels = []

    def timer(label):
        labels.append(label)
        return 10.0 + zlib.crc32(f"{salt}/{label}".encode()) % 997

    return timer, labels


@pytest.mark.parametrize("mode", ["smoke", "full"])
def test_sweep_with_an_injected_timer_equals_jax(mode, cached_setups):
    """build_table's forms through one injected timer: the same trial
    labels in the same order, the same entries (the exact form only in
    JAX's), and one autotune_trials_total count a trial in both."""
    tt, tl = _timer(mode)
    jt, jl = _timer(mode)
    ttel, jtel = Telemetry(), JTelemetry()
    got = tauto.build_table(mode, timer=tt, platform="cpu", device="cpu",
                            telemetry=ttel)
    want = jauto.build_table(mode, timer=jt, platform="cpu", telemetry=jtel)
    j_entries = [e for e in want.entries if e["form"] != "exact"]
    j_labels = [lb for lb in jl if not lb.startswith("exact/")]
    assert tl == j_labels and len(jl) > len(tl)
    assert got.entries == j_entries
    assert got.meta == {"generated_by": "repro_torch.tune.autotune",
                        "mode": mode}
    assert ttel.metrics.counter("autotune_trials_total").value == len(tl)
    assert jtel.metrics.counter("autotune_trials_total").value == len(jl)
    assert ttable.validate_doc(got.to_doc()) == []


@pytest.mark.parametrize("salt", ["ties", "b"])
def test_forms_tie_break_and_knee_as_jax(salt, cached_setups):
    """tune_causal_chunked and tune_scalars alone (full mode) with timers
    that tie (the first minimal candidate wins, the knee keeps the
    smallest) or differ."""
    timer = (lambda label: 5.0) if salt == "ties" else _timer(salt)[0]
    tt, jt = ttable.TuningTable(), jtable.TuningTable()
    shapes = ((512, 64, 8, 2, 2, 16), (1024, 32, 4, 2, 1, 8))
    kw = dict(timer=timer, platform="cpu", iters=2)
    tauto.tune_causal_chunked(tt, shapes=shapes, device="cpu", **kw)
    jauto.tune_causal_chunked(jt, shapes=shapes, **kw)
    tauto.tune_scalars(tt, mode="full", device="cpu", **kw)
    jauto.tune_scalars(jt, mode="full", **kw)
    assert tt.entries == jt.entries
    for cands in ([(4, 100.0), (8, 95.0), (32, 91.0)], [(8, 50.0)],
                  [(8, 120.0), (16, 100.0), (64, 111.0)]):
        assert tauto._knee(cands) == jauto._knee(cands)
    assert tauto.KNEE_TOLERANCE == jauto.KNEE_TOLERANCE
    assert tauto.QCB_CANDIDATES == jauto.QCB_CANDIDATES
    assert tauto.CAUSAL_SHAPES == jauto.CAUSAL_SHAPES


def test_smoke_sweep_times_real_serves_on_the_cpu(tmp_path):
    """The CLI on the CPU (asked for): the smoke sweep timed for real, a
    valid table written with the cpu key; a timed trial is one
    autotune_trial span with its label. Without --device cpu it needs a
    card."""
    out = tmp_path / "t.json"
    path = tauto.main(["--smoke", "--device", "cpu", "--out", str(out)])
    doc = json.loads(out.read_text())
    assert path == str(out) and ttable.validate_doc(doc) == []
    assert doc["mode"] == "smoke" and "card" not in doc
    assert {e["platform"] for e in doc["entries"]} == {"cpu"}
    tel = Telemetry()
    us = tauto._measure("probe", lambda: None, warmup=1, iters=2, tel=tel,
                        timer=None)
    spans = [e for e in tel.tracer.chrome_events()
             if e["ph"] == "X" and e["name"] == "autotune_trial"]
    assert us >= 0 and len(spans) == 1
    assert spans[0]["args"]["label"] == "probe"
    assert tel.metrics.counter("autotune_trials_total").value == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tauto.main(["--smoke", "--out", str(out)])


@pytest.fixture(scope="module")
def engines():
    cfg_j = dataclasses.replace(jax_smoke_config("qwen3-8b"),
                                dtype="float32")
    params_j = jax.jit(lambda key: jmodel.init_params(key, cfg_j))(
        jax.random.PRNGKey(2))
    flat = {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params_j)[0]}
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    params_t = bridge.params_from_flat(flat, cfg_t, device="cpu")
    rng = np.random.default_rng(6)
    prompts = [list(map(int, rng.integers(4, cfg_j.vocab_size, n)))
               for n in (8, 19, 35, 16, 40)]
    return cfg_j, params_j, cfg_t, params_t, prompts


def test_engine_resolves_the_tuned_decode_chunk_as_jax(engines):
    """Under the same table (cpu decode_chunk 4) both engines built with
    decode_chunk=None take 4 and serve the same tokens at the same ticks;
    the port's telemetry counts its table lookups a call: one at
    construction and one a prefill forward, all hits; under an empty
    table all misses."""
    cfg_j, params_j, cfg_t, params_t, prompts = engines
    budgets = [9, 12, 6, 10, 7]
    entry = dict(platform="cpu", form="scalars", bucket=None,
                 params={"decode_chunk": 4}, trial_us=1.0, default_us=1.0,
                 speedup=1.0, trials=1)
    with ttable.override(ttable.TuningTable([entry])), \
            jtable.override(jtable.TuningTable([entry])):
        jeng = JaxEngine(params_j, cfg_j, max_seq=96,
                         cache_dtype=jnp.float32, decode_chunk=None)
        want, jsched = jeng.serve(prompts, budgets, max_batch=2,
                                  return_scheduler=True)
        ttable.consume_stats()
        tel = Telemetry()
        eng = ServingEngine(params_t, cfg_t, max_seq=96, device="cpu",
                            cache_dtype=torch.float32, decode_chunk=None,
                            telemetry=tel)
        got, sched = eng.serve(prompts, budgets, max_batch=2,
                               return_scheduler=True)
    assert eng.decode_chunk == jeng.decode_chunk == 4
    assert got == want
    assert sched.completed_at == jsched.completed_at
    assert sched.stats.chunks == jsched.stats.chunks
    c = cfg_t.attention.linformer.block_size
    forwards = sum(len(p) >= c for p in prompts)    # a shorter one: decode
    assert tel.metrics.counter("tuning_table_hit_total").value == \
        1 + forwards
    assert tel.metrics.counter("tuning_table_miss_total").value == 0
    with ttable.override(None):
        tel = Telemetry()
        ServingEngine(params_t, cfg_t, max_seq=96, device="cpu",
                      cache_dtype=torch.float32, decode_chunk=4,
                      telemetry=tel).serve(prompts[:3], budgets[:3],
                                           max_batch=2)
    assert tel.metrics.counter("tuning_table_hit_total").value == 0
    assert tel.metrics.counter("tuning_table_miss_total").value == 2

"""The port's serving engine on a tensor-parallel mesh: gloo CPU ranks
against the JAX package's single-device engine.

The three scenarios of JAX's tp-mesh serving tests
(tests/test_attention_plan.py: chunked prefill; a snapshot round trip
through preemption and a fault's quarantine; a paged pool's snapshot into
fresh pages) on data2×tp2, one group of 4 gloo ranks
(tests/torch_mesh_ranks.py, `serve_cases`). The config is those tests'
2-layer plan-parity model in fp32 with a fp32 cache, JAX's weights bridged.
Every rank's tokens and scheduler counters equal JAX's single-device
engine; the pool leaves' local shapes follow `cache_pspecs` (Hkv over tp).
A snapshot gathers the heads: JAX's snapshot of the same admission,
restored into another row of the sharded pool (a paged one into fresh
pages), snapshots back to JAX's bytes and checksum, and the mesh's own
snapshot of the admission holds JAX's values (fp32 leaves within 1e-5,
the tolerance of the plan's cache-level tests: the ring and slots are
computed a head shard at a time, which moves their last bits; int8 codes
within one step). JAX's own tp-mesh serving legs need 8 host devices in a
subprocess and do not pass on every installation, so the single-device
engine is the oracle. A fourth case serves zamba2 SMOKE on the same mesh:
its attention entries hold this rank's heads, and its tokens equal the
same engine's with no mesh.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import AttentionConfig, LinformerConfig, ModelConfig
from repro.models import model as jmodel
from repro.serving import Fault as JFault
from repro.serving import FaultInjector as JInjector
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import SlotPool as JSlotPool
from repro.serving.scheduler import _STAT_COUNTERS

import torch_mesh_ranks

PROMPTS4 = [[5, 6, 7] * 6, [9, 10] * 8, [3] * 21, [8] * 4]
PROMPTS6 = PROMPTS4 + [[11, 4] * 5, [2, 3, 4] * 4]
BUDGETS = [16, 16, 16, 6, 6, 6]
KW = dict(max_batch=2, priorities=[3, 3, 3, 0, 0, 0],
          arrival_chunks=[0, 0, 0, 1, 1, 2], return_scheduler=True)
H, HKV, DH, C, R = 4, 2, 8, 8, 2


def _cfg():
    return ModelConfig(
        name="plan-parity", num_layers=2, d_model=32, vocab_size=256,
        max_seq_len=64,
        attention=AttentionConfig(
            kind="linformer_causal", num_heads=H, num_kv_heads=HKV,
            head_dim=DH, backend="reference",
            linformer=LinformerConfig(block_size=C, block_slots=R)),
        dtype="float32", remat="full")


def _stats(st):
    return {**{k: getattr(st, k) for k in _STAT_COUNTERS}, "ticks": st.ticks}


def _jax_snapshot(eng, prompt):
    sp = JSlotPool(eng, 2)
    cache, logits = eng.prefill(np.asarray([prompt], np.int32))
    req = JRequest(rid=0, tokens=tuple(prompt), max_new_tokens=4)
    sp.admit(0, req, cache, int(jnp.argmax(logits[0])))
    snap = sp.snapshot_rows([0], tick=0)[0]
    return {k: np.asarray(v) for k, v in snap.cache_rows.items()}, \
        snap.checksum


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = _cfg()
    params = jmodel.init_params(jax.random.PRNGKey(0), cfg)
    flat = {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params)[0]}
    tcfg = dataclasses.asdict(cfg)
    tcfg["attention"]["backend"] = "auto"

    def mk(**kw):
        return JEngine(params, cfg, max_seq=64, decode_chunk=4,
                       cache_dtype=jnp.float32, **kw)

    snaps = {"dense": _jax_snapshot(mk(), PROMPTS6[0]),
             "paged": _jax_snapshot(mk(cache_format="paged"), PROMPTS6[0])}
    finish = torch_mesh_ranks.start_ranks(
        tmp_path_factory.mktemp("serve_mesh"), "serve_cases",
        {"cfg": tcfg, "params": flat, "prompts4": PROMPTS4,
         "prompts6": PROMPTS6, "budgets": BUDGETS, "kw": KW,
         "jax_rows": {k: v[0] for k, v in snaps.items()}})
    one = mk(prefill_chunk=16)
    want = {"chunked": one.serve(PROMPTS4, 6, max_batch=2)}
    o, s = one.serve(PROMPTS6, BUDGETS, **KW)
    want["preempt"] = (o, _stats(s.stats))
    want["plain"] = one.serve(PROMPTS6, BUDGETS, max_batch=2)
    inj = JInjector([JFault("slot_step", chunk=1, row=0)])
    o, s = one.serve(PROMPTS6, BUDGETS, max_batch=2, snapshot_chunks=1,
                     fault_injector=inj, return_scheduler=True)
    want["fault"] = (o, _stats(s.stats))
    o, s = mk(prefill_chunk=16, cache_format="paged").serve(
        PROMPTS6, BUDGETS, snapshot_chunks=2, **KW)
    want["paged"] = (o, _stats(s.stats))
    want["snaps"] = snaps
    return want, finish()


def _pool_shapes(local, whole_hkv=HKV, tp=2):
    """Each leaf's head axis (nd-2, or the last for a scale leaf) holds
    Hkv/tp heads; lengths and the page table are whole."""
    for name, shape in local.items():
        if name in ("lengths", "page_table") or len(shape) < 2:
            continue
        head = shape[-1] if name.endswith("_s") else shape[-2]
        assert head == whole_hkv // tp, (name, shape)


def _check_snapshot(got, jax_rows, jax_crc):
    """The sharded pool's snapshot against JAX's of the same admission."""
    _pool_shapes(got["local"])
    assert got["verify"]
    assert got["jax_crc"] == jax_crc and got["back_crc"] == jax_crc
    for key, want in jax_rows.items():
        b, dt, shape = got["back"][key]
        assert shape == want.shape, key
        np.testing.assert_array_equal(b, want.reshape(-1).view(np.uint8),
                                      key)
        mine = got["snap"][key]
        if want.dtype == np.int8:
            assert np.abs(mine.astype(np.int32) - want).max() <= 1, key
        elif want.dtype == np.float32:
            np.testing.assert_allclose(mine, want, rtol=0, atol=1e-5,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(mine, want, key)


def test_chunked_prefill_on_tp_mesh(runs):
    want, ranks = runs
    for got in ranks:
        assert got["tp"] == 2
        _pool_shapes(got["pool"])
        assert got["chunked"] == want["chunked"]


def test_snapshot_roundtrip_on_tp_mesh(runs):
    want, ranks = runs
    assert want["preempt"][1]["preemptions"] > 0
    assert want["fault"][1]["quarantines"] == 1
    for got in ranks:
        assert got["preempt"] == want["preempt"]
        assert got["fault"] == want["fault"]
        assert got["fault"][0] == want["plain"]
        _check_snapshot(got["dense_snap"], *want["snaps"]["dense"])


def test_hybrid_serves_on_tp_mesh(runs):
    """zamba2 SMOKE: the shared block's attention entries hold this rank's
    heads, and the tokens equal the same engine's with no mesh."""
    _, ranks = runs
    for got in ranks:
        assert got["hybrid_tp"] == 2
        for name, shape in got["hybrid_attn"].items():
            head = shape[-1] if name.endswith("_s") else shape[-2]
            assert head * 2 == got["hybrid_whole_hkv"], (name, shape)
        assert got["hybrid"] == got["hybrid_one"]


def test_paged_snapshot_into_fresh_pages_on_tp_mesh(runs):
    want, ranks = runs
    assert want["paged"][1]["preemptions"] > 0
    for got in ranks:
        _pool_shapes(got["paged_pool"])
        assert got["paged"] == want["paged"]
        _check_snapshot(got["paged_snap"], *want["snaps"]["paged"])

"""The port's examples (examples_torch/) on the CPU, against the JAX
package's examples/ and engine.

Each `main` runs with `--device cpu`: quickstart at its own size,
serve_batched as is, long_context_decode at `--context 1024`, train_mlm at
2 layers for 20 steps and then again into the same checkpoint directory
with `--steps 40`, which must resume at step 20 (a rerun at the same
`--steps` has nothing left to train: JAX's example then fails reading the
empty metrics). The checks are the JAX examples' own (continuous ==
static, chunked admission leaves the short outputs unchanged, the long
request finishes last, finite losses) and the numbers that depend on the
config alone, equal to the JAX package's for the same config: the cache
bytes and compression ratio, the compressed slot counts and the parameter
estimate. serve_batched's tokens from bridged JAX `PRNGKey(0)` weights
equal JAX's `ServingEngine` on the first three requests."""
import argparse
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import LinformerConfig as JLinformerConfig
from repro.models import model as jmodel
from repro.serving.engine import ServingEngine as JaxEngine

from repro_torch.checkpoint import bridge
from repro_torch.configs import config_from_dict

from examples_torch import (long_context_decode, quickstart, serve_batched,
                            train_mlm)
from test_torch_dense_configs import _flatten_j

CPU = ["--device", "cpu"]
N_JAX = 3          # serve_batched's requests JAX serves


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qwen():
    """SMOKE qwen3-8b in fp32 as the examples build it: JAX's config and
    PRNGKey(0) params, the port's config and the bridged params."""
    cfg_j = dataclasses.replace(jax_smoke_config("qwen3-8b"), dtype="float32")
    params_j = jmodel.init_params(jax.random.PRNGKey(0), cfg_j)
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    params_t = bridge.params_from_flat(_flatten_j(params_j), cfg_t,
                                       device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture(scope="module")
def served(qwen):
    """serve_batched on the bridged weights, and JAX's engine on its first
    N_JAX requests (the example's engine settings)."""
    cfg_j, params_j, _, params_t = qwen
    got = serve_batched.main(CPU, params=params_t)
    eng = JaxEngine(params_j, cfg_j, max_seq=256, cache_dtype=jnp.float32,
                    decode_chunk=8)
    want = eng.serve_static(got["prompts"][:N_JAX], got["budgets"][:N_JAX],
                            max_batch=3)
    return got, want


def test_quickstart(qwen, capsys):
    cfg_j, params_j, _, _ = qwen
    got = quickstart.main(CPU)
    out = capsys.readouterr().out
    assert "model: qwen3-8b-smoke | attention: linformer_causal" in out
    assert len(got["losses"]) == 60
    assert all(math.isfinite(x) for x in got["losses"])
    assert got["losses"][-1] < got["losses"][0]
    assert got["checkpoints"] == [30, 60]
    assert [len(o) for o in got["outputs"]] == [12, 12]
    want = JaxEngine(params_j, cfg_j, max_seq=128,
                     cache_dtype=jnp.float32).cache_bytes(2)
    assert got["cache_bytes"] == want
    assert f"decode cache: {want} bytes" in out


def test_serve_batched_tokens_equal_jax(served):
    got, want = served
    assert got["outputs"][:N_JAX] == want


def test_serve_batched_invariants(served):
    got, _ = served
    assert got["outputs"] == got["outputs_static"]
    assert got["outputs_chunked"][1:] == got["outputs"]
    assert got["chunked_order"][-1] == 0
    assert sorted(got["completion_order"]) == list(range(6))
    assert got["prefill_tokens"] == 160 + sum(map(len, got["prompts"]))
    assert got["prefill_forwards"] > 0
    assert [len(o) for o in got["outputs"]] == got["budgets"]


def test_serve_batched_cache_bytes_equal_jax(qwen, served):
    cfg_j, params_j, _, _ = qwen
    got, _ = served
    comp = JaxEngine(params_j, cfg_j, max_seq=256,
                     cache_dtype=jnp.float32).cache_bytes(4)
    full = JaxEngine(params_j, cfg_j.with_attention_kind("standard"),
                     max_seq=256, cache_dtype=jnp.float32).cache_bytes(4)
    assert (got["cache_bytes"], got["cache_bytes_standard"]) == (comp, full)
    assert got["compression"] == full / comp


def test_long_context_decode_equals_jax_layout(capsys):
    context, new = 1024, 32
    got = long_context_decode.main(CPU + ["--context", str(context)])
    assert "prefill 1024 tokens" in capsys.readouterr().out
    assert len(got["tokens"]) == new
    # JAX example's config, its cache by shape alone
    base = jax_smoke_config("qwen3-8b")
    cfg_j = dataclasses.replace(
        base, dtype="float32", max_seq_len=context * 2,
        attention=dataclasses.replace(
            base.attention, linformer=JLinformerConfig(
                k=64, sharing="layerwise", block_size=256, block_slots=16)))
    c, r = 256, 16
    max_seq = context + new + c
    params = jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), cfg_j))
    cache = jax.eval_shape(lambda p, t: jmodel.forward(
        p, cfg_j, {"tokens": t}, return_cache=True, cache_max_seq=max_seq,
        cache_dtype=jnp.float32)[2], params,
        jax.ShapeDtypeStruct((1, context), jnp.int32))
    want = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(cache))
    assert got["cache_bytes"] == want
    assert (got["compressed_slots"], got["raw_slots"]) == \
        ((context // c) * r, c)
    assert got["full_bytes"] == (2 * cfg_j.num_layers * max_seq *
                                 cfg_j.attention.num_kv_heads *
                                 cfg_j.attention.head_dim * 4)


def test_train_mlm_resumes(tmp_path):
    from repro.configs.linformer_paper import CONFIG as JPAPER
    from repro.configs.base import (AttentionConfig, LinformerConfig,
                                    MLPConfig)
    argv = CPU + ["--layers", "2", "--ckpt-dir", str(tmp_path)]
    first = train_mlm.main(argv + ["--steps", "20"])
    assert first["steps"] == list(range(1, 21))
    second = train_mlm.main(argv + ["--steps", "40"])
    assert second["steps"] == list(range(21, 41))
    for run in (first, second):
        assert all(math.isfinite(x) for x in run["losses"])
    # the JAX example's config for the same flags
    a = argparse.Namespace(layers=2, d_model=256, heads=4, seq=128, k=32,
                           sharing="layerwise", attention="linformer",
                           vocab=2048)
    cfg_j = dataclasses.replace(
        JPAPER, num_layers=a.layers, d_model=a.d_model, vocab_size=a.vocab,
        max_seq_len=a.seq, dtype="float32", remat="none",
        attention=AttentionConfig(
            kind=a.attention, num_heads=a.heads, num_kv_heads=a.heads,
            head_dim=a.d_model // a.heads, causal=False, use_rope=False,
            linformer=LinformerConfig(k=a.k, sharing=a.sharing)),
        mlp=MLPConfig(d_ff=4 * a.d_model, activation="gelu"))
    assert first["n_params"] == cfg_j.param_count_estimate
    assert dataclasses.asdict(train_mlm.config(a)) == \
        dataclasses.asdict(cfg_j)

"""Serving parity: the PyTorch port's ServingEngine against the JAX engine
on qwen3-8b SMOKE in fp32 with bridged weights, on the CPU.

Greedy token lists must be identical. Both engines get `decode_chunk`
explicitly (the JAX default comes from TUNING.json)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as jmodel
from repro.serving.engine import ServingEngine as JaxEngine

from repro_torch.checkpoint import bridge
from repro_torch.configs import config_from_dict
from repro_torch.serving import ServingEngine

MAX_SEQ = 96
DECODE_CHUNK = 4
# 8 requests; with c = 16 every budget below crosses at least one block
# boundary while decoding
PROMPT_LENS = [8, 16, 19, 35, 48, 8, 19, 35]
BUDGETS = [12, 20, 9, 17, 30, 25, 14, 11]


@pytest.fixture(scope="module")
def setup():
    cfg_j = dataclasses.replace(jax_smoke_config("qwen3-8b"),
                                dtype="float32")
    params_j = jmodel.init_params(jax.random.PRNGKey(1), cfg_j)
    flat = {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params_j)[0]}
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    params_t = bridge.params_from_flat(flat, cfg_t, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(4, cfg_j.vocab_size, n)))
               for n in PROMPT_LENS]
    return cfg_j, params_j, cfg_t, params_t, prompts


@pytest.fixture(scope="module")
def torch_engine(setup):
    _, _, cfg_t, params_t, _ = setup
    return ServingEngine(params_t, cfg_t, max_seq=MAX_SEQ, device="cpu",
                         cache_dtype=torch.float32,
                         decode_chunk=DECODE_CHUNK)


def test_serve_matches_jax_engine(setup, torch_engine):
    cfg_j, params_j, _, _, prompts = setup
    jeng = JaxEngine(params_j, cfg_j, max_seq=MAX_SEQ,
                     cache_dtype=jnp.float32, decode_chunk=DECODE_CHUNK)
    want = jeng.serve(prompts, BUDGETS, max_batch=3)
    got, sched = torch_engine.serve(prompts, BUDGETS, max_batch=3,
                                    return_scheduler=True)
    assert got == want
    assert [len(o) for o in got] == BUDGETS        # no EOS at random init
    assert sched.stats.prefill_forwards == len(prompts)
    assert sched.stats.quarantines == 0


def test_continuous_matches_static(setup, torch_engine):
    *_, prompts = setup
    cont = torch_engine.serve(prompts, BUDGETS, max_batch=3,
                              arrival_chunks=[0, 0, 1, 1, 2, 4, 4, 6])
    static = torch_engine.serve_static(prompts, BUDGETS, max_batch=3)
    assert cont == static


def test_serve_streams_tokens_in_order(setup, torch_engine):
    *_, prompts = setup
    streamed = {}
    done = {}
    outs = torch_engine.serve(
        prompts[:4], 6, max_batch=2,
        on_token=lambda rid, tok: streamed.setdefault(rid, []).append(tok),
        on_complete=lambda rid, toks: done.__setitem__(rid, list(toks)))
    assert [streamed[i] for i in range(4)] == outs
    assert [done[i] for i in range(4)] == outs


def test_engine_defaults_to_cuda(setup):
    _, _, cfg_t, params_t, _ = setup
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        ServingEngine(params_t, cfg_t, max_seq=MAX_SEQ)


def test_budget_checks_and_cache_bytes(setup, torch_engine):
    cfg_j, params_j, *_ = setup
    with pytest.raises(ValueError, match="exceeds max_seq"):
        torch_engine.serve([[5] * 90], 10)
    with pytest.raises(ValueError, match="empty prompt"):
        torch_engine.serve([[]], 4)
    jeng = JaxEngine(params_j, cfg_j, max_seq=MAX_SEQ,
                     cache_dtype=jnp.float32, decode_chunk=DECODE_CHUNK)
    assert torch_engine.cache_bytes(3) == jeng.cache_bytes(3)

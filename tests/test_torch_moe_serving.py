"""Serving parity of the PyTorch port with the JAX package on the MoE
configs (qwen3-moe-30b-a3b and kimi-k2-1t-a32b SMOKE, fp32, JAX weights
bridged): the dense pool with monolithic and chunked (P = 32) admission and
the paged int8 pool with chunked admission, tokens identical to the JAX
engine with the same settings. The SMOKE configs' capacity factor (8.0)
drops no token; ``test_torch_moe_capacity.py`` holds the legs where rows
compete for expert slots. A request may end early on EOS (the random
weights emit it): its row then rides along finished, as in JAX."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.engine import ServingEngine as JaxEngine

from repro_torch.serving import ServingEngine

from test_torch_dense_configs import BUDGETS, DECODE_CHUNK, MAX_SEQ, \
    PROMPT_LENS
from test_torch_moe_model import MOE, moe_setup


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port while this module runs: its
    SMOKE-sized ops gain nothing from more, and under the test run's
    parallel workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def prompts_for(vocab):
    rng = np.random.default_rng(11)
    return [list(map(int, rng.integers(4, vocab, n))) for n in PROMPT_LENS]


def serve_matches_jax(setup, cache_format, prefill_chunk):
    """The serve trace through the port's engine and the JAX engine with
    the same settings: tokens identical, the same prefill counts, no
    quarantine, every page free after a paged serve."""
    cfg_j, params_j, cfg_t, params_t, prompts = setup
    kw = dict(max_seq=MAX_SEQ, decode_chunk=DECODE_CHUNK,
              prefill_chunk=prefill_chunk, cache_format=cache_format)
    want, jsched = JaxEngine(params_j, cfg_j, cache_dtype=jnp.float32,
                             **kw).serve(prompts, BUDGETS, max_batch=3,
                                         return_scheduler=True)
    got, sched = ServingEngine(params_t, cfg_t, device="cpu",
                               cache_dtype=torch.float32, **kw).serve(
        prompts, BUDGETS, max_batch=3, return_scheduler=True)
    assert got == want
    assert sched.stats.prefill_forwards == jsched.stats.prefill_forwards
    assert sched.stats.prefill_tokens == jsched.stats.prefill_tokens
    assert sched.stats.quarantines == 0
    if cache_format == "paged":
        assert sched.pool.alloc.free_pages == sched.pool.alloc.usable_pages


@pytest.fixture(scope="module", params=MOE)
def setup(request):
    cfg_j, params_j, cfg_t, params_t = moe_setup(request.param)
    return cfg_j, params_j, cfg_t, params_t, prompts_for(cfg_j.vocab_size)


@pytest.mark.parametrize("cache_format,prefill_chunk",
                         [("dense", 0), ("dense", 32), ("paged", 32)])
def test_serve_matches_jax_engine(setup, cache_format, prefill_chunk):
    serve_matches_jax(setup, cache_format, prefill_chunk)

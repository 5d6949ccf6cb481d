"""Serving parity of the PyTorch port with the JAX package on qwen3-14b,
nemotron-4-15b and qwen1.5-110b SMOKE (fp32, JAX weights bridged) through
the dense pool: monolithic and chunked (P = 32) admission, tokens identical
to the JAX engine with the same settings. Setup and check are
``test_torch_dense_configs.py``'s; this file holds their dense-pool cases
so that the test run spreads them over another worker."""
import pytest
import torch

from test_torch_dense_configs import DENSE, dense_setup, serve_matches_jax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port while this module runs: its
    SMOKE-sized ops gain nothing from more, and under the test run's
    parallel workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=DENSE)
def setup(request):
    return dense_setup(request.param)


@pytest.mark.parametrize("prefill_chunk", [0, 32])
def test_serve_matches_jax_engine(setup, prefill_chunk):
    serve_matches_jax(setup, "dense", prefill_chunk)

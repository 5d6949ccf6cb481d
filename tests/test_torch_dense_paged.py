"""Serving parity of the PyTorch port with the JAX package on qwen3-14b,
nemotron-4-15b and qwen1.5-110b SMOKE (fp32, JAX weights bridged) through
the paged int8 pool with chunked admission (P = 32): tokens identical to
the JAX paged engine, every page free after the serve. Setup and check are
``test_torch_dense_configs.py``'s."""
import pytest

from test_torch_dense_configs import DENSE, dense_setup, serve_matches_jax


@pytest.fixture(scope="module", params=DENSE)
def setup(request):
    return dense_setup(request.param)


def test_paged_serve_matches_jax_engine(setup):
    serve_matches_jax(setup, "paged", 32)

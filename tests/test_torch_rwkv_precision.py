"""The precision of the port's fp32 RWKV6 loss gradients against an fp64
run of the same port code, beside JAX's fp32 gradients against the same
oracle.

The RWKV6 time mix's backward through its exp(±cum) factors is
ill-conditioned (models/rwkv6.py's docstring), so each package's fp32
gradients carry rounding the other's need not share. The oracle is the
port's own code with every float32 it names set to float64
(`rwkv_model.float64_reference`) and the weights widened, which JAX's
scan over an fp32 state cannot run.
Inputs: rwkv6 SMOKE with the width and head dim of each case,
`init_params(PRNGKey(0))` bridged from JAX, and one causal batch of 8 × 32
from `SyntheticCorpus(seed=0)`. A gradient's error is its largest
difference from the oracle's as a share of the oracle leaf's largest
entry; a case's error is its worst leaf's. Bound: the port's error at
most 2× JAX's and at most MAX_ERR.

`scripts/rwkv_precision.py` prints these errors, and the spread of the
two packages' AdamW moments after three steps, with the WKV in fp64 (the
port) or fp32 (the port before it)."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.data import pipeline as jpipe
from repro.models import model as jmodel

from repro_torch.checkpoint import bridge
from repro_torch.configs import config_from_dict
from repro_torch.models import model as tmodel
from repro_torch.models.rwkv_model import float64_reference
from repro_torch.models import transformer as ttransformer

from test_torch_dense_configs import _flatten_j

# (width, head dim): 96 is where the port's fp32 WKV once erred 1.0e-4
SHAPES = [(96, 16), (64, 32), (64, 16), (48, 16)]
MAX_ERR = 5e-5
JAX_FACTOR = 2.0
B, S = 8, 32
def setup(width, head_dim, seed=0):
    """(JAX config, JAX params, the port's config, flat params, the
    batches of steps 0, 1 and 2)."""
    base = get_smoke_config("rwkv6-1.6b")
    cfg_j = dataclasses.replace(
        base, dtype="float32", d_model=width,
        rwkv=dataclasses.replace(base.rwkv, head_dim=head_dim))
    params_j = jmodel.init_params(jax.random.PRNGKey(seed), cfg_j)
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    corpus = jpipe.SyntheticCorpus(cfg_j.vocab_size, seed=0)
    batches = [jpipe.make_causal_batch(corpus, jpipe.DataState(step, 0),
                                       batch=B, seq=S) for step in range(3)]
    return cfg_j, params_j, cfg_t, _flatten_j(params_j), batches


def port_params(flat, cfg_t, dtype):
    """Bridged port params in `dtype`, every leaf requiring grad."""
    p = bridge.params_from_flat(flat, cfg_t, device="cpu")
    return ttransformer.nest({k: v.to(dtype).requires_grad_()
                              for k, v in ttransformer.flatten(p).items()})


def port_grads(flat, cfg_t, batch, f64=False):
    """{key: the loss gradient, float64 numpy} of the port, in fp32 or,
    with `f64`, the fp64 oracle."""
    dt = torch.float64 if f64 else torch.float32
    with float64_reference() if f64 else contextlib.nullcontext():
        params = port_params(flat, cfg_t, dt)
        leaves = ttransformer.flatten(params)
        bt = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        loss, _ = tmodel.loss_fn(params, cfg_t, bt)
        assert loss.dtype == dt
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return {k: g.double().numpy() for k, g in zip(leaves, grads)}


def jax_grads(params_j, cfg_j, batch):
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    g = jax.grad(lambda p: jmodel.loss_fn(p, cfg_j, bj)[0])(params_j)
    return {k: np.asarray(v, np.float64) for k, v in _flatten_j(g).items()}


def worst(got, ref):
    """(the largest |got - ref| as a share of the ref leaf's largest
    entry, that leaf)."""
    return max((float(np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max()),
                k) for k in ref if np.abs(ref[k]).max() > 0)


def grad_errors(width, head_dim):
    """{"port": (err, leaf), "jax": (err, leaf)} against the fp64 oracle."""
    cfg_j, params_j, cfg_t, flat, batches = setup(width, head_dim)
    oracle = port_grads(flat, cfg_t, batches[0], f64=True)
    return {"port": worst(port_grads(flat, cfg_t, batches[0]), oracle),
            "jax": worst(jax_grads(params_j, cfg_j, batches[0]), oracle)}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_oracle_runs_in_float64():
    """The oracle's time mix, state and logits are float64 end to end."""
    cfg_j, _, cfg_t, flat, batches = setup(48, 16)
    with float64_reference():
        params = port_params(flat, cfg_t, torch.float64)
        toks = torch.from_numpy(np.array(batches[0]["tokens"]))
        logits, _, cache = tmodel.forward(params, cfg_t, {"tokens": toks},
                                          return_cache=True,
                                          cache_dtype=torch.float64)
    assert logits.dtype == torch.float64
    assert cache["wkv"].dtype == torch.float64


@pytest.mark.parametrize("width,head_dim", SHAPES)
def test_fp32_gradients_within_jax_error(width, head_dim):
    errs = grad_errors(width, head_dim)
    port, jax_err = errs["port"][0], errs["jax"][0]
    assert port <= MAX_ERR, errs
    assert port <= JAX_FACTOR * jax_err, errs

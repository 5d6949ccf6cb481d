"""Temperature sampling: the PyTorch port against the JAX package on
qwen3-8b SMOKE in fp32 with bridged weights, on the CPU.

At temperature 0 the port is greedy and token-identical to JAX. Above it,
`jax.random` cannot be reproduced in torch, so the port's Gumbel-max
sampler (`model.sample`, the method `jax.random.categorical` uses) is held
to JAX's softmax(logits / T) for the same bridged logits by a chi-square
test of 20000 seeded draws (bins of expected count >= 5, the tail merged;
p > 1e-3, fixed seeds so the test is deterministic)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sstats

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as jmodel
from repro.serving.engine import ServingEngine as JaxEngine

from repro_torch.checkpoint import bridge
from repro_torch.configs import config_from_dict
from repro_torch.configs.base import ServeConfig
from repro_torch.data.pipeline import EOS
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.serving import ServingEngine

MAX_SEQ = 96
DECODE_CHUNK = 4
N_DRAWS = 20000


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
    params_j = jmodel.init_params(jax.random.PRNGKey(9), cfg_j)
    flat = {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params_j)[0]}
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    params_t = bridge.params_from_flat(flat, cfg_t, device="cpu")
    rng = np.random.default_rng(13)
    prompts = [list(map(int, rng.integers(4, 512, n)))
               for n in (9, 16, 19, 35, 40)]
    return cfg_j, params_j, cfg_t, params_t, prompts


@pytest.fixture(scope="module")
def jax_logits(setup):
    """JAX's last-token prefill logits of prompt 3 (the distribution
    cases' common reference: the temperature enters only their softmax)."""
    cfg_j, params_j, _, _, prompts = setup
    jeng = JaxEngine(params_j, cfg_j, max_seq=MAX_SEQ,
                     cache_dtype=jnp.float32, decode_chunk=DECODE_CHUNK)
    return jeng.prefill(np.asarray([prompts[3]], np.int32))[1]


def _engine(setup, **kw):
    _, _, cfg_t, params_t, _ = setup
    return ServingEngine(params_t, cfg_t, max_seq=MAX_SEQ, device="cpu",
                         cache_dtype=torch.float32,
                         decode_chunk=DECODE_CHUNK, **kw)


def test_zero_temperature_is_argmax():
    logits = torch.randn(5, 37, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tmodel.sample(logits), logits.argmax(-1))
    assert torch.equal(tmodel.sample(logits, 0.0, torch.Generator()),
                       logits.argmax(-1))
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        tmodel.sample(logits, 0.7)


def test_greedy_serve_unchanged_as_in_jax(setup):
    """temperature=0 (the default) stays token-identical to JAX's greedy
    serve, whatever generator is passed."""
    cfg_j, params_j, _, _, prompts = setup
    want = JaxEngine(params_j, cfg_j, max_seq=MAX_SEQ,
                     cache_dtype=jnp.float32, decode_chunk=DECODE_CHUNK
                     ).serve(prompts, 10, max_batch=2)
    eng = _engine(setup, temperature=0.0)
    assert eng.serve(prompts, 10, max_batch=2) == want
    assert eng.serve(prompts, 10, max_batch=2,
                     generator=torch.Generator().manual_seed(7)) == want


@pytest.mark.parametrize("temperature", [0.8, 1.5])
def test_sampler_matches_jax_distribution(setup, jax_logits, temperature):
    """20000 Gumbel-max draws from the port's last-token logits of a prompt
    against JAX's softmax(logits / T) of the same bridged model's logits:
    chi-square over bins of expected count >= 5."""
    *_, prompts = setup
    toks = np.asarray([prompts[3]], np.int32)
    jlogits = jax_logits
    probs = np.asarray(jax.nn.softmax(jlogits[0] / temperature),
                       np.float64)
    eng = _engine(setup, temperature=temperature)
    _, logits = eng.prefill(toks.astype(np.int64))
    np.testing.assert_allclose(logits[0].numpy(), np.asarray(jlogits[0]),
                               atol=1e-4, rtol=0)
    gen = torch.Generator().manual_seed(0)
    draws = eng._sample(logits.expand(N_DRAWS, -1), gen).numpy()
    counts = np.bincount(draws, minlength=probs.size).astype(np.float64)
    expected = N_DRAWS * probs / probs.sum()
    big = expected >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    if exp[-1] < 5:                       # too little tail mass to bin
        obs, exp = obs[:-1], exp[:-1]
    exp *= obs.sum() / exp.sum()
    chi2 = ((obs - exp) ** 2 / exp).sum()
    p = sstats.chi2.sf(chi2, len(obs) - 1)
    assert big.sum() > 20                 # a real spread of categories
    assert p > 1e-3, (chi2, len(obs), p)


@pytest.mark.parametrize("kw", [dict(), dict(prefill_chunk=32),
                                dict(prefill_chunk=32, cache_format="paged")])
def test_same_generator_seed_same_tokens(setup, kw):
    """T > 0: one seed gives one token stream (first tokens at admission
    and the decode chunks draw from the same generator), another seed
    another; no token is EOS-frozen by the sampling."""
    *_, prompts = setup
    eng = _engine(setup, temperature=0.8, **kw)

    def run(seed):
        return eng.serve(prompts, 10, max_batch=2,
                         generator=torch.Generator().manual_seed(seed))

    a = run(3)
    assert a == run(3)
    assert a != run(4)
    assert a != _engine(setup, **kw).serve(prompts, 10, max_batch=2)


def test_finished_rows_stay_frozen(setup):
    """At T > 0 a finished row emits EOS and keeps its position counter;
    the live rows advance."""
    _, _, cfg_t, params_t, _ = setup
    cache = tmodel.init_cache(cfg_t, batch=3, max_seq=MAX_SEQ,
                              dtype=torch.float32, device="cpu")
    cache["lengths"][:] = torch.tensor([0, 0, 0], dtype=torch.int32)
    toks, cur, fin, bad, cache = tmodel.decode_scan(
        params_t, cfg_t, torch.tensor([5, 6, 7]),
        torch.tensor([True, False, True]), cache, n_steps=6, eos_id=EOS,
        temperature=1.0, generator=torch.Generator().manual_seed(0))
    assert (toks[0] == EOS).all() and (toks[2] == EOS).all()
    assert cache["lengths"].tolist() == [0, 6, 0]
    assert fin[0] and fin[2] and not bad.any()


def test_generator_device_is_checked(setup):
    """A generator on another device than the engine's raises (it is never
    moved); none gives a fresh one seeded 0 on the engine's device."""
    eng = _engine(setup)

    class OnCuda:
        device = torch.device("cuda", 0)

    with pytest.raises(ValueError, match="engine's device"):
        eng.resolve_generator(OnCuda())
    g = eng.resolve_generator(None)
    assert g.device.type == "cpu" and g.initial_seed() == 0


def test_launcher_temperature():
    """--temperature reaches the engine (default: ServeConfig's, greedy):
    sampled runs repeat (the generator is seeded) and differ from the
    greedy run."""
    argv = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
            "--requests", "4", "--max-new-tokens", "6"]
    assert ServeConfig().temperature == 0.0
    greedy = tserve.main(argv)
    sampled = tserve.main(argv + ["--temperature", "0.8"])
    assert sampled == tserve.main(argv + ["--temperature", "0.8"])
    assert sampled != greedy
    assert greedy == tserve.main(argv + ["--temperature", "0"])

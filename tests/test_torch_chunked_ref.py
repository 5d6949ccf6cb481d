"""The chunked reference form of the blockwise-causal attention and its
routing: the PyTorch port against the JAX package on the CPU in fp32.

The same numpy inputs (seeded) go through JAX's
`blockwise_causal_attention_chunked` (jitted, its ``lax.map``) and the
port's (a Python loop over query chunks), at every chunk width of the sweep
(1, 2, 4, 8 blocks and 3, which does not divide the 8 blocks and falls back
to 1), GQA groups 1 and 2, a shared (c, r) E/F and per-head (Hkv, c, r)
ones. Routing: both packages under the same `override` table, whose cpu
``chunked_min_seq`` is 32, so that a 64-token SMOKE sequence takes the
chunked form on the reference route and on the plain backward route.

Tolerances: outputs and logits 1e-5 absolute; gradients 1e-5 of each
tensor's largest entry (fp32, other summation orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import causal as jcausal
from repro.kernels import ops as jops
from repro.models import model as jmodel
from repro.tune import table as jtuning

from repro_torch.checkpoint import bridge
from repro_torch.configs import config_from_dict, get_smoke_config
from repro_torch.core import causal as tcausal
from repro_torch.kernels import ops as tops
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttransformer
from repro_torch.models import zamba as tzamba
from repro_torch.tune import table as ttuning

ATOL = 1e-5
GRAD_TOL = 1e-5
B, HKV, DH, C, R, NB = 2, 2, 8, 8, 2, 8
S = C * NB
# (q_chunk_blocks, G, per-head E/F): every width with both groups and both
# E/F layouts among them; 3 does not divide the 8 blocks
CASES = [(1, 1, False), (2, 2, True), (4, 1, True), (8, 2, False),
         (3, 2, True)]
MIN_SEQ = 32               # the override tables' cpu chunked_min_seq


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's SMOKE-sized ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(G, per_head, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    ef = (HKV, C, R) if per_head else (C, R)
    return (f(B, S, G * HKV, DH), f(B, S, HKV, DH), f(B, S, HKV, DH),
            f(*ef) * R ** -0.5, f(*ef) * R ** -0.5, f(B, S, G * HKV, DH))


def _grad_close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=GRAD_TOL * scale, rtol=0, err_msg=what)


def _table(jax_side: bool, **scalars):
    mod = jtuning if jax_side else ttuning
    return mod.TuningTable([dict(
        platform="cpu", form="scalars", bucket=None, params=scalars,
        trial_us=1.0, default_us=1.0, speedup=1.0, trials=1)])


@pytest.mark.parametrize("qcb,G,per_head", CASES)
def test_chunked_form_matches_jax(qcb, G, per_head):
    """Output and the gradients of q, k, v, E and F against jax.vjp of the
    JAX form at the same chunk width; the port's chunked form equals its
    plain form too."""
    *xs, do = _inputs(G, per_head, seed=qcb + 10 * G)
    kw = dict(block_size=C)

    def fwd_bwd(*a):
        out, vjp = jax.vjp(
            lambda *a_: jcausal.blockwise_causal_attention_chunked(
                *a_, q_chunk_blocks=qcb, **kw), *a[:5])
        return out, vjp(a[5])

    want, want_g = jax.jit(fwd_bwd)(*map(jnp.asarray, xs + [do]))
    leaves = [torch.from_numpy(x).requires_grad_() for x in xs]
    got = tcausal.blockwise_causal_attention_chunked(
        *leaves, q_chunk_blocks=qcb, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    got_g = torch.autograd.grad(got, leaves, torch.from_numpy(do))
    for name, g, w in zip("qkvEF", got_g, want_g):
        _grad_close(g, w, name)
    plain = tcausal.blockwise_causal_attention(*leaves, **kw)
    np.testing.assert_allclose(got.detach().numpy(),
                               plain.detach().numpy(), atol=ATOL, rtol=0)


def test_chunk_width_resolves_through_the_table():
    """q_chunk_blocks=None takes the table's causal_chunked entry for the
    sequence's bucket in both packages (4 here; a miss takes 8)."""
    *xs, _ = _inputs(2, False, seed=5)
    entry = dict(platform="cpu", form="causal_chunked", bucket={"seq": S},
                 params={"q_chunk_blocks": 4}, trial_us=1.0, default_us=1.0,
                 speedup=1.0, trials=1)
    with jtuning.override(jtuning.TuningTable([entry])), \
            ttuning.override(ttuning.TuningTable([entry])):
        assert ttuning.q_chunk_blocks_for(seq=S, platform="cpu") == \
            jtuning.q_chunk_blocks_for(seq=S) == 4
        want = jcausal.blockwise_causal_attention_chunked(
            *map(jnp.asarray, xs), block_size=C)
        got = tcausal.blockwise_causal_attention_chunked(
            *map(torch.from_numpy, xs), block_size=C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    with ttuning.override(None):
        assert ttuning.q_chunk_blocks_for(seq=S, platform="cpu") == 8


def test_threshold_follows_the_table_per_platform():
    """chunked_attention_min_seq: the table's scalar for the asked
    platform, else 8192 (JAX's constant), as JAX's for its backend."""
    assert tcausal.CHUNKED_ATTENTION_MIN_SEQ == \
        jcausal.CHUNKED_ATTENTION_MIN_SEQ == 8192
    with jtuning.override(_table(True, chunked_min_seq=MIN_SEQ)), \
            ttuning.override(_table(False, chunked_min_seq=MIN_SEQ)):
        assert tcausal.chunked_attention_min_seq("cpu") == \
            jcausal.chunked_attention_min_seq() == MIN_SEQ
        assert tcausal.chunked_attention_min_seq("cuda:X") == 8192
    with ttuning.override(None):
        assert tcausal.chunked_attention_min_seq("cpu") == 8192


@pytest.fixture
def chunked_calls(monkeypatch):
    """Counts calls of the port's chunked form (the plan and the wrappers
    read it from their modules at call time)."""
    calls = []
    real = tcausal.blockwise_causal_attention_chunked

    def spy(*a, **k):
        calls.append(a[0].shape[1])
        return real(*a, **k)

    monkeypatch.setattr(tcausal, "blockwise_causal_attention_chunked", spy)
    monkeypatch.setattr(tops, "blockwise_causal_attention_chunked", spy)
    return calls


@pytest.fixture(scope="module")
def smoke():
    cfg_j = dataclasses.replace(jax_smoke_config("qwen3-8b"),
                                dtype="float32").with_attention_backend(
                                    "reference")
    params_j = jax.jit(lambda key: jmodel.init_params(key, cfg_j))(
        jax.random.PRNGKey(3))
    flat = {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params_j)[0]}
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    rng = np.random.default_rng(4)
    toks = rng.integers(4, cfg_j.vocab_size, (2, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": np.ones((2, S), np.int32)}
    return cfg_j, params_j, cfg_t, flat, batch


def test_reference_route_logits_and_grads_match_jax(smoke, chunked_calls):
    """qwen3-8b SMOKE on the reference route under chunked_min_seq=32:
    the forward's logits and the loss's gradients (remat "full") equal
    JAX's, and every layer's attention ran the chunked form."""
    cfg_j, params_j, cfg_t, flat, batch = smoke
    with jtuning.override(_table(True, chunked_min_seq=MIN_SEQ)), \
            ttuning.override(_table(False, chunked_min_seq=MIN_SEQ)):
        want, _, _ = jax.jit(lambda p, t: jmodel.forward(
            p, cfg_j, {"tokens": t}))(params_j, jnp.asarray(batch["tokens"]))
        (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
            lambda p, b: jmodel.loss_fn(p, cfg_j, b), has_aux=True))(
                params_j, {k: jnp.asarray(v) for k, v in batch.items()})
        params_t = bridge.params_from_flat(flat, cfg_t, device="cpu")
        leaves = ttransformer.flatten(params_t)
        for p in leaves.values():
            p.requires_grad_(True)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.no_grad():
            got, _, _ = tmodel.forward(params_t, cfg_t, {"tokens": tb[
                "tokens"]})
        n_fwd = len(chunked_calls)
        loss_t, _ = tmodel.loss_fn(params_t, cfg_t, tb)
        grads_t = torch.autograd.grad(loss_t, list(leaves.values()))
    assert n_fwd == cfg_t.num_layers and set(chunked_calls) == {S}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    flat_gj = {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                        for p in path): leaf
               for path, leaf in jax.tree_util.tree_flatten_with_path(
                   grads_j)[0]}
    for (name, _), g in zip(leaves.items(), grads_t):
        _grad_close(g, flat_gj[name], name)


def test_plain_backward_route_is_chunked_past_the_threshold(chunked_calls):
    """The kernel wrapper with backward_impl="reference" takes the plain
    backward route: chunked from the threshold on, as JAX's
    _bca_bwd_reference, with JAX's gradients."""
    *xs, do = _inputs(2, True, seed=7)
    kw = dict(block_size=C, block_slots=R, scale=DH ** -0.5,
              backward_impl="reference")
    with jtuning.override(_table(True, chunked_min_seq=MIN_SEQ)), \
            ttuning.override(_table(False, chunked_min_seq=MIN_SEQ)):
        _, vjp = jax.vjp(lambda *a: jops.fused_blockwise_causal_attention(
            *a, interpret=True, **kw), *map(jnp.asarray, xs))
        want = vjp(jnp.asarray(do))
        leaves = [torch.from_numpy(x).requires_grad_() for x in xs]
        got = torch.autograd.grad(tops.fused_blockwise_causal_attention(
            *leaves, **kw), leaves, torch.from_numpy(do))
    assert chunked_calls == [S]
    for name, g, w in zip("qkvEF", got, want):
        _grad_close(g, w, name)
    with ttuning.override(None):
        torch.autograd.grad(tops.fused_blockwise_causal_attention(
            *leaves, **kw), leaves, torch.from_numpy(do))
    assert chunked_calls == [S]          # under 8192: the plain form


def test_zamba_shared_block_keeps_jax_literal(chunked_calls):
    """zamba2's shared block routes on JAX's literal S >= 8192, not on the
    tuned threshold: a 64-token forward stays plain under
    chunked_min_seq=32, which a transformer forward takes."""
    cfg = get_smoke_config("zamba2-1.2b").with_attention_backend("reference")
    cfg = dataclasses.replace(cfg, dtype="float32")
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(4, cfg.vocab_size, (1, S),
                         generator=torch.Generator().manual_seed(0))
    with ttuning.override(_table(False, chunked_min_seq=MIN_SEQ)), \
            torch.no_grad():
        tzamba.forward(params, cfg, {"tokens": toks})
        assert chunked_calls == []
        qcfg = get_smoke_config("qwen3-8b").with_attention_backend(
            "reference")
        tmodel.forward(tmodel.init_params(qcfg, seed=0, device="cpu"), qcfg,
                       {"tokens": toks})
    assert chunked_calls == [S] * qcfg.num_layers

"""Parity of the PyTorch port's model with the JAX package on qwen3-8b
SMOKE in fp32, with the JAX parameters bridged into the port.

JAX runs as its own tests run it on the CPU (``backend="auto"``: the Pallas
kernels in interpret mode); the port runs on the CPU, where its kernel
wrappers use their plain twins. Tolerances: 1e-4 absolute on logits and
cache leaves (fp32, different summation orders), exact on tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as jmodel

from repro_torch.checkpoint import bridge
from repro_torch.configs import config_from_dict, get_smoke_config
from repro_torch.data.pipeline import EOS
from repro_torch.models import model as tmodel

ATOL = 1e-4
MAX_SEQ = 128
LEAVES = ("raw_k", "raw_v", "comp_k", "comp_v")


def _flatten(tree):
    """{path: np.ndarray}, keyed as the JAX checkpointer's _flatten."""
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def setup():
    cfg_j = dataclasses.replace(jax_smoke_config("qwen3-8b"),
                                dtype="float32")
    params_j = jmodel.init_params(jax.random.PRNGKey(0), cfg_j)
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    params_t = bridge.params_from_flat(_flatten(params_j), cfg_t,
                                       device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(4, 512, (B, S))


def _jax_prefill(cfg_j, params_j, toks):
    fn = jax.jit(lambda p, t: jmodel.forward(
        p, cfg_j, {"tokens": t}, return_cache=True, cache_max_seq=MAX_SEQ,
        cache_dtype=jnp.float32))
    return fn(params_j, jnp.asarray(toks, jnp.int32))


def _torch_prefill(cfg_t, params_t, toks):
    with torch.no_grad():
        return tmodel.forward(params_t, cfg_t,
                              {"tokens": torch.from_numpy(toks)},
                              return_cache=True, cache_max_seq=MAX_SEQ,
                              cache_dtype=torch.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def test_config_copy_round_trips():
    cfg_j = jax_smoke_config("qwen3-8b")
    assert dataclasses.asdict(get_smoke_config("qwen3-8b")) == \
        dataclasses.asdict(cfg_j)
    assert config_from_dict(dataclasses.asdict(cfg_j)) == \
        get_smoke_config("qwen3-8b")


def test_bridge_reads_a_jax_checkpoint(setup, tmp_path):
    cfg_j, params_j, cfg_t, params_t = setup
    path = Checkpointer(str(tmp_path)).save(3, {"params": params_j})
    loaded = bridge.params_from_flat(bridge.read_params_npz(path), cfg_t,
                                     device="cpu")
    flat = _flatten(params_j)
    assert np.array_equal(loaded["layers"]["attn"]["wq"].numpy(),
                          flat["layers/attn/wq"])
    assert np.array_equal(loaded["shared"]["lin"]["E"].numpy(),
                          flat["shared/lin/E"])
    with pytest.raises(KeyError, match="missing"):
        bridge.params_from_flat({k: v for k, v in flat.items()
                                 if k != "lm_head"}, cfg_t, device="cpu")


@pytest.mark.parametrize("S", [16, 48])
def test_forward_logits_and_prefill_cache(setup, S):
    cfg_j, params_j, cfg_t, params_t = setup
    toks = _tokens(2, S, seed=S)
    lj, _, cj = _jax_prefill(cfg_j, params_j, toks)
    lt, _, ct = _torch_prefill(cfg_t, params_t, toks)
    assert lt.shape == (2, S, cfg_t.padded_vocab_size)
    _close(lt, lj)
    for leaf in LEAVES:
        _close(ct[leaf], cj[leaf])
    assert ct["lengths"].tolist() == np.asarray(cj["lengths"]).tolist()


def test_decode_steps_across_two_folds(setup):
    """40 decode steps from a 48-token prefill; row 1 is set back to
    position 41, so the two rows sit at unequal positions. Row 0 folds at
    t = 63 and 79, row 1 at t = 47, 63 and 79."""
    cfg_j, params_j, cfg_t, params_t = setup
    toks = _tokens(2, 48, seed=5)
    _, _, cj = _jax_prefill(cfg_j, params_j, toks)
    _, _, ct = _torch_prefill(cfg_t, params_t, toks)
    cj = dict(cj, lengths=jnp.asarray([48, 41], jnp.int32))
    ct["lengths"] = torch.tensor([48, 41], dtype=torch.int32)
    step_j = jax.jit(lambda p, b, c: jmodel.decode_step(p, cfg_j, b, c))
    feed = _tokens(2, 40, seed=6)
    for i in range(40):
        lj, cj = step_j(params_j,
                        {"tokens": jnp.asarray(feed[:, i:i + 1], jnp.int32)},
                        cj)
        with torch.no_grad():
            lt, ct = tmodel.decode_step(params_t, cfg_t,
                                        torch.from_numpy(feed[:, i:i + 1]),
                                        ct)
        _close(lt, lj)
        if i % 8 == 7 or i == 39:
            for leaf in LEAVES:
                _close(ct[leaf], cj[leaf])
    assert ct["lengths"].tolist() == [88, 81]


def test_decode_scan_tokens_finished_bad_lengths(setup):
    cfg_j, params_j, cfg_t, params_t = setup
    toks = _tokens(3, 32, seed=7)
    _, _, cj = _jax_prefill(cfg_j, params_j, toks)
    _, _, ct = _torch_prefill(cfg_t, params_t, toks)
    cur = np.asarray([5, 9, EOS])
    fin = np.asarray([False, True, False])
    scan_j = jax.jit(lambda p, cu, f, c, r: jmodel.decode_scan(
        p, cfg_j, cu, f, c, r, n_steps=12, eos_id=EOS))
    cur_j, fin_j = jnp.asarray(cur, jnp.int32), jnp.asarray(fin)
    cur_t, fin_t = torch.from_numpy(cur), torch.from_numpy(fin)
    rng = jax.random.PRNGKey(0)
    for _ in range(2):                      # two chunks: 24 steps, one fold
        tj, cur_j, fin_j, bad_j, cj, rng = scan_j(params_j, cur_j, fin_j,
                                                  cj, rng)
        with torch.no_grad():
            tt, cur_t, fin_t, bad_t, ct = tmodel.decode_scan(
                params_t, cfg_t, cur_t, fin_t, ct, n_steps=12, eos_id=EOS)
        assert tt.tolist() == np.asarray(tj).tolist()
        assert cur_t.tolist() == np.asarray(cur_j).tolist()
        assert fin_t.tolist() == np.asarray(fin_j).tolist()
        assert bad_t.tolist() == np.asarray(bad_j).tolist()
        assert ct["lengths"].tolist() == np.asarray(cj["lengths"]).tolist()
        for leaf in LEAVES:
            _close(ct[leaf], cj[leaf])
    # finished rows froze their positions; the live row advanced 24 steps
    assert ct["lengths"].tolist() == [56, 32, 32]
    assert not bad_t.any()

"""Serving a trained model from its checkpoint, and the per-token decode
baseline, in the PyTorch port against the JAX package (qwen3-8b SMOKE in
fp32 on the CPU).

* ``Checkpointer.restore_latest``: (None, None) on an empty directory, the
  newest of two steps otherwise.
* The port's Trainer saves; the port's serve launcher with ``--ckpt-dir``
  serves those params and gives the same tokens as the JAX engine over the
  params the JAX ``Checkpointer`` restores from the same npz.
* ``generate_batch_per_token`` (one host round trip a token) equals
  ``generate_batch`` (device-resident chunks) token for token at T = 0, in
  both packages, with rows reaching EOS mid-run.

JAX runs as its own tests run it on the CPU (the Pallas kernels in
interpret mode); the port's kernel wrappers run their plain twins. Tokens
are compared exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as jmodel
from repro.serving.engine import ServingEngine as JaxEngine

from repro_torch.checkpoint import bridge
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import config_from_dict
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.data.pipeline import EOS
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttransformer
from repro_torch.serving import ServingEngine
from repro_torch.train import Trainer

ARCH = "qwen3-8b"


def _flatten_j(tree):
    """{path: np.ndarray}, keyed as the JAX checkpointer's _flatten."""
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _cfgs():
    cfg_j = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32")
    return cfg_j, config_from_dict(dataclasses.asdict(cfg_j))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two Trainer steps of the SMOKE config in fp32, checkpointed after
    each: the directory and the trainer's in-memory params."""
    _, cfg_t = _cfgs()
    d = str(tmp_path_factory.mktemp("ckpt"))
    tcfg = TrainConfig(seq_len=32, global_batch=2, steps=2,
                       checkpoint_every=1, checkpoint_dir=d,
                       optimizer=OptimizerConfig(lr=1e-2, warmup_steps=1,
                                                 total_steps=2))
    trainer = Trainer(cfg_t, tcfg, device="cpu", log_fn=lambda s: None)
    trainer.run()
    return d, trainer._params


def test_restore_latest_empty_and_two_steps(trained, tmp_path):
    d, params = trained
    _, cfg_t = _cfgs()
    template = {"params": ttransformer.init_params(
        cfg_t, generator=torch.Generator().manual_seed(1),
        device=torch.device("cpu"))}
    assert Checkpointer(str(tmp_path / "empty")).restore_latest(
        template) == (None, None)
    ck = Checkpointer(d)
    assert ck.all_steps() == [1, 2]
    restored, meta = ck.restore_latest(template)
    assert meta["step"] == 2
    for k, v in ttransformer.flatten(restored["params"]).items():
        assert torch.equal(v, ttransformer.flatten(params)[k].detach()), k


def test_launcher_serves_the_checkpoint_as_jax_does(trained, tmp_path):
    """`--ckpt-dir` serves the saved step: the same tokens as the JAX
    engine over the params JAX restores from the same directory, and as
    the port's engine over the trainer's in-memory params."""
    d, params = trained
    cfg_j, cfg_t = _cfgs()
    got = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--ckpt-dir", d, "--requests", "6",
                       "--max-new-tokens", "10"])
    prompts = tserve.synthetic_prompts(cfg_j.vocab_size, 16, 6)
    restored, meta = JCheckpointer(d).restore_latest(
        {"params": jmodel.init_params(jax.random.PRNGKey(0), cfg_j)})
    assert meta["step"] == 2
    want = JaxEngine(restored["params"], cfg_j, max_seq=256,
                     cache_dtype=jnp.float32, decode_chunk=32).serve(
        prompts, 10, max_batch=4)
    assert got == want
    mem = ServingEngine(params, cfg_t, max_seq=256, device="cpu",
                        cache_dtype=torch.float32, decode_chunk=32).serve(
        prompts, 10, max_batch=4)
    assert got == mem
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path / "none")])


@pytest.fixture(scope="module")
def eos_params():
    """JAX SMOKE params whose lm_head swaps the EOS column with a token X
    that row 1 first emits at step 6 of a greedy run: the swapped model
    emits EOS exactly where the original emitted X."""
    cfg_j, cfg_t = _cfgs()
    params_j = jmodel.init_params(jax.random.PRNGKey(5), cfg_j)
    prompts = np.random.default_rng(6).integers(4, cfg_j.vocab_size, (3, 20))
    eng = ServingEngine(bridge.params_from_flat(_flatten_j(params_j), cfg_t,
                                                device="cpu"),
                        cfg_t, max_seq=64, device="cpu",
                        cache_dtype=torch.float32, decode_chunk=4)
    first = eng.generate_batch(prompts, 24)
    x = int(first[1, 6])
    assert x not in first[1, :6] and x not in first[:, 0] and x != EOS
    head = np.array(params_j["lm_head"])
    head[:, [EOS, x]] = head[:, [x, EOS]]
    params_j = dict(params_j, lm_head=jnp.asarray(head))
    return params_j, prompts


def test_per_token_loop_equals_the_scan(eos_params):
    cfg_j, cfg_t = _cfgs()
    params_j, prompts = eos_params
    jeng = JaxEngine(params_j, cfg_j, max_seq=64, cache_dtype=jnp.float32,
                     decode_chunk=4)
    want = jeng.generate_batch(prompts, 24)
    assert np.array_equal(jeng.generate_batch_per_token(prompts, 24), want)
    teng = ServingEngine(bridge.params_from_flat(_flatten_j(params_j), cfg_t,
                                                 device="cpu"),
                         cfg_t, max_seq=64, device="cpu",
                         cache_dtype=torch.float32, decode_chunk=4)
    got = teng.generate_batch(prompts, 24)
    assert np.array_equal(got, want)
    assert np.array_equal(teng.generate_batch_per_token(prompts, 24), want)
    # row 1 reaches EOS at step 6 and stays there; not every row is done
    assert (got[1, 6:] == EOS).all() and (got[1, :6] != EOS).all()
    assert not (got[:, -1] == EOS).all()

"""Parity of the PyTorch port with the JAX package on the MoE configs,
qwen3-moe-30b-a3b and kimi-k2-1t-a32b, in fp32 at SMOKE size with the JAX
weights bridged: the parameter layout and checkpoints (the router fp32 in a
bf16 model), the forward's logits, aux loss and cache, decode steps,
``decode_scan``, ``prefill_chunk``, and a train step whose loss adds
``aux_loss_weight`` times the aux loss. Serving is held in
``test_torch_moe_serving.py``.

JAX runs as its own tests run it on the CPU (``backend="auto"``: the Pallas
kernels in interpret mode); the port runs on the CPU, where its kernel
wrappers use their plain twins. Each config's JAX parameters and jitted
functions are made once per module (a fixture parametrised by config).
Tolerances: 1e-4 absolute on logits and cache leaves; 1e-5 absolute on the
aux loss; tokens exact; the train step's loss 1e-5 relative, every gradient
leaf 1e-5 of its largest entry, parameters after the step 1e-6 absolute
(lr 1e-3)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.data import pipeline as jpipe
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.train import trainer as jtrainer

from repro_torch.checkpoint import bridge
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import config_from_dict, get_smoke_config
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.data.pipeline import EOS
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw_init
from repro_torch.train import Trainer, make_train_step

from test_torch_dense_configs import _flatten_j

MOE = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
ATOL = 1e-4
AUX_ATOL = 1e-5
MAX_SEQ = 96
P = 32
LEAVES = ("raw_k", "raw_v", "comp_k", "comp_v")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=1.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port while this module runs: its
    SMOKE-sized ops gain nothing from more, and under the test run's
    parallel workers more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def moe_setup(arch, **moe_kw):
    """(JAX config, JAX params, port config, bridged port params) of one
    SMOKE config in fp32 and remat "full", its MoE fields replaced by
    `moe_kw`."""
    cfg_j = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                                remat="full")
    cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(cfg_j.moe,
                                                               **moe_kw))
    params_j = jmodel.init_params(jax.random.PRNGKey(2), cfg_j)
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    params_t = bridge.params_from_flat(_flatten_j(params_j), cfg_t,
                                       device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture(scope="module", params=MOE)
def setup(request):
    cfg_j, params_j, cfg_t, params_t = moe_setup(request.param)
    prefill = jax.jit(lambda p, t: jmodel.forward(
        p, cfg_j, {"tokens": t}, return_cache=True, cache_max_seq=MAX_SEQ,
        cache_dtype=jnp.float32))
    step = jax.jit(lambda p, b, c: jmodel.decode_step(p, cfg_j, b, c))
    return dict(cfg_j=cfg_j, params_j=params_j, cfg_t=cfg_t,
                params_t=params_t, prefill=prefill, step=step)


def _tokens(B, S, seed, vocab=512):
    return np.random.default_rng(seed).integers(4, vocab, (B, S))


def _torch_prefill(s, toks):
    with torch.no_grad():
        return tmodel.forward(s["params_t"], s["cfg_t"],
                              {"tokens": torch.from_numpy(toks)},
                              return_cache=True, cache_max_seq=MAX_SEQ,
                              cache_dtype=torch.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def test_param_layout_checkpoints_and_fp32_router(setup, tmp_path):
    """param_spec has JAX's keys and shapes (moe/* for mlp/*); a JAX npz
    loads unchanged; bridged into the bf16 config, and through the port's
    Checkpointer, the router stays fp32 and the experts are bf16."""
    cfg_t, params_j = setup["cfg_t"], setup["params_j"]
    flat_j = _flatten_j(params_j)
    spec = ttransformer.param_spec(cfg_t)
    assert {k: tuple(v[0]) for k, v in spec.items()} == \
        {k: v.shape for k, v in flat_j.items()}
    path = JCheckpointer(str(tmp_path / "jax")).save(1, {"params": params_j})
    npz = bridge.read_params_npz(path)
    for k, v in ttransformer.flatten(bridge.params_from_flat(
            npz, cfg_t, device="cpu")).items():
        assert np.array_equal(v.numpy(), flat_j[k]), k
    cfg16 = dataclasses.replace(cfg_t, dtype="bfloat16")
    for p16 in (bridge.params_from_flat(npz, cfg16, device="cpu"),
                bridge.params_from_flat(npz, cfg_t, device="cpu",
                                        dtype=torch.bfloat16)):
        leaves = ttransformer.flatten(p16)
        assert leaves["layers/moe/router"].dtype == torch.float32
        assert np.array_equal(leaves["layers/moe/router"].numpy(),
                              flat_j["layers/moe/router"])
        assert leaves["layers/moe/w_in"].dtype == torch.bfloat16
        assert leaves["layers/attn/wq"].dtype == torch.bfloat16
    ck = Checkpointer(str(tmp_path / "port"))
    ck.save(3, {"params": p16})
    restored, _ = ck.restore_latest({"params": tmodel.init_params(
        cfg16, seed=5, device="cpu")})
    for k, v in ttransformer.flatten(restored["params"]).items():
        assert v.dtype == leaves[k].dtype and torch.equal(v, leaves[k]), k


def test_forward_logits_aux_and_prefill_cache(setup):
    toks = _tokens(2, 48, seed=1)
    lj, aux_j, cj = setup["prefill"](setup["params_j"],
                                     jnp.asarray(toks, jnp.int32))
    lt, aux_t, ct = _torch_prefill(setup, toks)
    assert lt.shape == (2, 48, setup["cfg_t"].padded_vocab_size)
    _close(lt, lj)
    assert float(aux_t) > 0
    np.testing.assert_allclose(float(aux_t), float(aux_j), atol=AUX_ATOL,
                               rtol=0)
    for leaf in LEAVES:
        _close(ct[leaf], cj[leaf])
    assert ct["lengths"].tolist() == np.asarray(cj["lengths"]).tolist()


def test_decode_steps_across_two_folds(setup):
    """24 decode steps from a 32-token prefill, row 1 set back to
    position 27: row 0 folds at t = 47, row 1 at t = 31 and 47."""
    cfg_t, params_t = setup["cfg_t"], setup["params_t"]
    toks = _tokens(2, 32, seed=5)
    _, _, cj = setup["prefill"](setup["params_j"],
                                jnp.asarray(toks, jnp.int32))
    _, _, ct = _torch_prefill(setup, toks)
    cj = dict(cj, lengths=jnp.asarray([32, 27], jnp.int32))
    ct["lengths"] = torch.tensor([32, 27], dtype=torch.int32)
    feed = _tokens(2, 24, seed=6)
    for i in range(24):
        lj, cj = setup["step"](
            setup["params_j"],
            {"tokens": jnp.asarray(feed[:, i:i + 1], jnp.int32)}, cj)
        with torch.no_grad():
            lt, ct = tmodel.decode_step(params_t, cfg_t,
                                        torch.from_numpy(feed[:, i:i + 1]),
                                        ct)
        _close(lt, lj)
    for leaf in LEAVES:
        _close(ct[leaf], cj[leaf])
    assert ct["lengths"].tolist() == [56, 51]


def test_decode_scan_tokens(setup):
    """20 scan steps over three rows, one of them finished: its EOS token
    still routes beside the live rows, as in JAX."""
    cfg_j, cfg_t = setup["cfg_j"], setup["cfg_t"]
    toks = _tokens(3, 32, seed=7)
    _, _, cj = setup["prefill"](setup["params_j"],
                                jnp.asarray(toks, jnp.int32))
    _, _, ct = _torch_prefill(setup, toks)
    cur = np.asarray([5, 9, EOS])
    fin = np.asarray([False, True, False])
    tj, cur_j, fin_j, bad_j, cj, _ = jax.jit(
        lambda p, cu, f, c, r: jmodel.decode_scan(
            p, cfg_j, cu, f, c, r, n_steps=20, eos_id=EOS))(
        setup["params_j"], jnp.asarray(cur, jnp.int32), jnp.asarray(fin),
        cj, jax.random.PRNGKey(0))
    with torch.no_grad():
        tt, cur_t, fin_t, bad_t, ct = tmodel.decode_scan(
            setup["params_t"], cfg_t, torch.from_numpy(cur),
            torch.from_numpy(fin), ct, n_steps=20, eos_id=EOS)
    assert tt.tolist() == np.asarray(tj).tolist()
    assert cur_t.tolist() == np.asarray(cur_j).tolist()
    assert fin_t.tolist() == np.asarray(fin_j).tolist()
    assert bad_t.tolist() == np.asarray(bad_j).tolist()
    for leaf in LEAVES:
        _close(ct[leaf], cj[leaf])


def test_prefill_chunk_matches_jax(setup):
    """Two prefill chunks per row at unequal offsets and valid counts (a
    padded garbage block routes with the rest): logits and every cache
    leaf after each chunk."""
    cfg_j, cfg_t = setup["cfg_j"], setup["cfg_t"]
    B, c = 3, cfg_t.attention.linformer.block_size
    cache_j = jmodel.init_cache(cfg_j, batch=B, max_seq=MAX_SEQ + P,
                                dtype=jnp.float32)
    cache_t = tmodel.init_cache(cfg_t, batch=B, max_seq=MAX_SEQ + P,
                                dtype=torch.float32, device="cpu")
    chunk_j = jax.jit(lambda p, t, cache, nv: jmodel.prefill_chunk(
        p, cfg_j, {"tokens": t}, cache, nv))
    rng = np.random.default_rng(40)
    for n_valid in ([P, c, P], [c, P, P]):
        toks = rng.integers(4, cfg_j.vocab_size, (B, P)).astype(np.int32)
        nv = np.asarray(n_valid, np.int32)
        lj, cache_j = chunk_j(setup["params_j"], jnp.asarray(toks), cache_j,
                              jnp.asarray(nv))
        with torch.no_grad():
            lt, cache_t = tmodel.prefill_chunk(
                setup["params_t"], cfg_t,
                torch.from_numpy(toks.astype(np.int64)), cache_t,
                torch.from_numpy(nv))
        _close(lt, lj)
        for name in cache_j:
            _close(cache_t[name], cache_j[name])


def test_train_step_with_aux_loss_matches_jax(setup):
    """Under remat "full": loss_fn's total (CE + aux_loss_weight · aux),
    its metrics, every gradient leaf (the fp32 router's among them), then
    one make_train_step step: loss, aux, grad norm and every parameter
    after AdamW."""
    cfg_j, cfg_t, params_j = setup["cfg_j"], setup["cfg_t"], \
        setup["params_j"]
    batch = jpipe.make_causal_batch(jpipe.SyntheticCorpus(512, seed=0),
                                    jpipe.DataState(0, 0), batch=2, seq=32)
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    batch_t = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}

    def params_t():
        p = bridge.params_from_flat(_flatten_j(params_j), cfg_t,
                                    device="cpu")
        for leaf in ttransformer.flatten(p).values():
            leaf.requires_grad_(True)
        return p

    (total_j, met_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, cfg_j, b), has_aux=True))(
            params_j, batch_j)
    pt = params_t()
    total_t, met_t = tmodel.loss_fn(pt, cfg_t, batch_t)
    flat = ttransformer.flatten(pt)
    grads_t = torch.autograd.grad(total_t, list(flat.values()))
    np.testing.assert_allclose(float(total_t.detach()), float(total_j),
                               rtol=1e-5)
    for name in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(met_t[name].detach()),
                                   float(met_j[name]), rtol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(
        float(total_t.detach()),
        float(met_t["loss"].detach()) + cfg_t.moe.aux_loss_weight
        * float(met_t["aux_loss"].detach()), rtol=1e-6)
    flat_gj = _flatten_j(grads_j)
    assert set(flat) == set(flat_gj)
    for (k, _), g in zip(flat.items(), grads_t):
        want = flat_gj[k]
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5 * scale,
                                   rtol=0, err_msg=k)
    assert float(np.abs(flat_gj["layers/moe/router"]).max()) > 0

    pj, _, mj = jax.jit(jtrainer.make_train_step(
        cfg_j, JOptimizerConfig(**OPT)))(
        params_j, jadamw.adamw_init(params_j, JOptimizerConfig(**OPT)),
        batch_j)
    pt = params_t()
    pt, _, mt = make_train_step(cfg_t, OptimizerConfig(**OPT))(
        pt, adamw_init(pt, OptimizerConfig(**OPT)), batch_t)
    for name in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(mt[name]), float(mj[name]),
                                   rtol=1e-5, err_msg=name)
    flat_pj = _flatten_j(pj)
    for k, v in ttransformer.flatten(pt).items():
        np.testing.assert_allclose(v.detach().numpy(), flat_pj[k],
                                   atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("arch", MOE)
def test_remat_full_carries_the_aux_gradient(arch):
    """The aux loss crosses the remat boundary with its gradient: the
    total and every gradient leaf under remat "full" equal those without
    remat, and the router's gradient differs from that of the CE alone."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             jpipe.make_causal_batch(jpipe.SyntheticCorpus(512, seed=1),
                                     jpipe.DataState(1, 0), batch=2,
                                     seq=32).items()}
    params = tmodel.init_params(cfg, seed=3, device="cpu")
    leaves = list(ttransformer.flatten(params).values())
    for p in leaves:
        p.requires_grad_(True)
    got = {}
    for remat in ("none", "full"):
        total, met = tmodel.loss_fn(params, dataclasses.replace(
            cfg, remat=remat), batch)
        got[remat] = (total.detach(),
                      torch.autograd.grad(total, leaves, retain_graph=True),
                      torch.autograd.grad(met["loss"], leaves))
    (t0, g0, ce0), (t1, g1, _) = got["none"], got["full"]
    assert torch.allclose(t0, t1, rtol=1e-6, atol=0)
    for a, b in zip(g0, g1):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)
    k = list(ttransformer.flatten(params)).index("layers/moe/router")
    assert not torch.allclose(g1[k], ce0[k], rtol=1e-3, atol=0)


def test_trainer_and_launchers_run_both_configs(tmp_path, caplog):
    """The Trainer's metrics and history carry aux_loss; both launchers
    run --smoke of both configs on the CPU, the serve launcher from the
    train launcher's checkpoint."""
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    tr = Trainer(cfg, TrainConfig(seq_len=32, global_batch=2, steps=2,
                                  checkpoint_every=0, log_every=1),
                 device="cpu")
    m = tr.run()
    assert m["aux_loss"] > 0 and len(tr.history) == 2
    assert all(h["aux_loss"] > 0 for h in tr.history)
    caplog.set_level("INFO")
    for arch in MOE:
        train_launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--steps", "1", "--seq", "32", "--batch", "2",
                           "--ckpt-dir", str(tmp_path)])
        serve_launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--requests", "3", "--max-new-tokens", "4",
                           "--ckpt-dir", str(tmp_path / arch)])
    assert "aux=" in caplog.text
    assert caplog.text.count("restored step 1") == 2


def test_unrolled_layout_logits_aux_and_gradients():
    """qwen3-moe SMOKE with scan_layers=False (``layers_list/{i}/moe/*``):
    logits, the aux loss summed over the unrolled layers, and every
    gradient leaf of the total loss, against JAX."""
    cfg_j = dataclasses.replace(jax_smoke_config("qwen3-moe-30b-a3b"),
                                dtype="float32", scan_layers=False)
    params_j = jmodel.init_params(jax.random.PRNGKey(4), cfg_j)
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    flat_j = _flatten_j(params_j)
    assert "layers_list/1/moe/router" in flat_j
    params_t = bridge.params_from_flat(flat_j, cfg_t, device="cpu")
    batch = jpipe.make_causal_batch(jpipe.SyntheticCorpus(512, seed=2),
                                    jpipe.DataState(2, 0), batch=2, seq=32)
    lj, aux_j, _ = jax.jit(lambda p, t: jmodel.forward(
        p, cfg_j, {"tokens": t}))(params_j, jnp.asarray(batch["tokens"]))
    with torch.no_grad():
        lt, aux_t, _ = tmodel.forward(
            params_t, cfg_t, {"tokens": torch.from_numpy(batch["tokens"])})
    _close(lt, lj)
    np.testing.assert_allclose(float(aux_t), float(aux_j), atol=AUX_ATOL,
                               rtol=0)
    grads_j = _flatten_j(jax.jit(jax.grad(lambda p, b: jmodel.loss_fn(
        p, cfg_j, b)[0]))(params_j, {k: jnp.asarray(v)
                                     for k, v in batch.items()}))
    leaves = ttransformer.flatten(params_t)
    for p in leaves.values():
        p.requires_grad_(True)
    total, _ = tmodel.loss_fn(params_t, cfg_t, {
        k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    for (k, _), g in zip(leaves.items(), torch.autograd.grad(
            total, list(leaves.values()))):
        scale = max(1.0, float(np.abs(grads_j[k]).max()))
        np.testing.assert_allclose(g.numpy(), grads_j[k],
                                   atol=1e-5 * scale, rtol=0, err_msg=k)

"""Parity of the PyTorch port's training slice with the JAX package, on the
CPU in fp32: data pipeline, losses, optimizer, train step, checkpoints and
the trainer's entry points.

Inputs are made with numpy from a seed and handed to both packages; JAX
parameters are bridged into the port. JAX runs as its tests run it on the
CPU (``backend="auto"``: the Pallas kernels, backward included, in
interpret mode); the port's kernel wrappers run their plain twins on CPU
tensors. Tolerances: 1e-4 relative on losses; gradients 1e-5 of each
leaf's largest entry; the optimizer's pieces 1e-6 relative (the same fp32
arithmetic in another order); parameters after the train steps as stated
at the test."""
import dataclasses
import json
import os

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
from repro.optim import grad_utils as jgrad
from repro.optim import schedules as jsched
from repro.train import trainer as jtrainer

from repro_torch.checkpoint import bridge
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import config_from_dict
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               make_schedule)
from repro_torch.train import Trainer, make_train_step

LOSS_RTOL = 1e-4
GRAD_TOL = 1e-5
OPT_RTOL = 1e-6
B, S = 2, 32


def _flatten_j(tree):
    """{path: np.ndarray}, keyed as the JAX checkpointer's _flatten."""
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np_tree(tree_t):
    return {k: v.detach().numpy()
            for k, v in ttransformer.flatten(tree_t).items()}


def _leaf_close(got, want, tol, what):
    """|got - want| <= tol · max(1, max|want|), per leaf."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0,
                               err_msg=what)


@pytest.fixture(scope="module")
def smoke():
    cfg_j = dataclasses.replace(jax_smoke_config("qwen3-8b"),
                                dtype="float32")
    params_j = jmodel.init_params(jax.random.PRNGKey(0), cfg_j)
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    return cfg_j, params_j, cfg_t


def _params_t(cfg_t, params_j):
    params = bridge.params_from_flat(_flatten_j(params_j), cfg_t,
                                     device="cpu")
    for p in ttransformer.flatten(params).values():
        p.requires_grad_(True)
    return params


def _batch_np(vocab, step=0, seq=S):
    corpus = jpipe.SyntheticCorpus(vocab, seed=0)
    return jpipe.make_causal_batch(corpus, jpipe.DataState(0, step),
                                   batch=B, seq=seq)


def _to_t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("vocab,shard", [(512, 0), (151936, 3)])
def test_batches_match_jax_byte_for_byte(vocab, shard):
    js = jpipe.batches(jpipe.SyntheticCorpus(vocab, seed=5),
                       jpipe.DataState(5, 2), batch=3, seq=257, shard=shard)
    ts = tpipe.batches(tpipe.SyntheticCorpus(vocab, seed=5),
                       tpipe.DataState(5, 2), batch=3, seq=257, shard=shard)
    for _ in range(3):
        (bj, sj), (bt, st) = next(js), next(ts)
        assert sj.to_dict() == st.to_dict()
        assert sorted(bj) == sorted(bt)
        for k in bj:
            assert bj[k].dtype == bt[k].dtype
            assert bj[k].tobytes() == bt[k].tobytes()
    # the MLM stream is ported too (tests/test_torch_encoder.py holds it
    # at more shapes): its first batch is the JAX package's
    (bj, _), (bt, _) = (next(pipe.batches(pipe.SyntheticCorpus(vocab),
                                          pipe.DataState(), batch=1, seq=8,
                                          objective="mlm", shard=shard))
                        for pipe in (jpipe, tpipe))
    assert all(bj[k].tobytes() == bt[k].tobytes() for k in bj)


# -- optimizer ----------------------------------------------------------------


def _tree_np(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"w": (4, 8), "b": (8,), "stack/w": (2, 3, 5)}


def _nest_j(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moment_dtype):
    cfg = dict(lr=1e-2, weight_decay=0.1, moment_dtype=moment_dtype)
    cfg_j, cfg_t = JOptimizerConfig(**cfg), OptimizerConfig(**cfg)
    p0 = _tree_np(0, SHAPES)
    params_j = _nest_j(p0)
    params_t = ttransformer.nest({k: torch.from_numpy(v.copy())
                                  for k, v in p0.items()})
    opt_j = jadamw.adamw_init(params_j, cfg_j)
    opt_t = adamw_init(params_t, cfg_t)
    for step in range(3):
        g = _tree_np(10 + step, SHAPES)
        lr = 1e-2 * (step + 1) / 3
        params_j, opt_j = jadamw.adamw_update(
            _nest_j(g), opt_j, params_j, cfg_j, jnp.float32(lr))
        params_t, opt_t = adamw_update(
            ttransformer.nest({k: torch.from_numpy(v) for k, v in g.items()}),
            opt_t, params_t, cfg_t, torch.tensor(lr, dtype=torch.float32))
    assert int(opt_t["step"]) == int(opt_j["step"]) == 3
    for tree_t, tree_j in ((params_t, params_j), (opt_t["mu"], opt_j["mu"]),
                           (opt_t["nu"], opt_j["nu"])):
        flat_j = _flatten_j(tree_j)
        for k, v in ttransformer.flatten(tree_t).items():
            assert str(v.dtype)[6:] == str(flat_j[k].dtype)
            np.testing.assert_allclose(
                v.float().numpy(), flat_j[k].astype(np.float32),
                rtol=OPT_RTOL if moment_dtype == "float32" else 2 ** -8,
                atol=1e-7, err_msg=k)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedules_match_jax(schedule):
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=50, schedule=schedule)
    lr_j = jsched.make_schedule(JOptimizerConfig(**cfg))
    lr_t = make_schedule(OptimizerConfig(**cfg))
    for step in (0, 1, 6, 7, 8, 30, 49, 50, 80):
        got = lr_t(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(lr_j(step)),
                                   rtol=OPT_RTOL, atol=0)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree_np(3, SHAPES)
    want, gn_j = jgrad.clip_by_global_norm(_nest_j(g), max_norm)
    got, gn_t = clip_by_global_norm(
        ttransformer.nest({k: torch.from_numpy(v) for k, v in g.items()}),
        max_norm)
    np.testing.assert_allclose(float(gn_t), float(gn_j), rtol=OPT_RTOL)
    flat_j = _flatten_j(want)
    for k, v in ttransformer.flatten(got).items():
        np.testing.assert_allclose(v.numpy(), flat_j[k], rtol=OPT_RTOL,
                                   atol=1e-7, err_msg=k)


# -- losses -------------------------------------------------------------------


@pytest.mark.parametrize("chunked_ce", [0, 16])
def test_loss_and_grads_match_jax(smoke, chunked_ce):
    """loss_fn on SMOKE fp32 with bridged weights, plain and chunked CE:
    loss within 1e-4 relative, every gradient leaf within 1e-5 of its
    largest entry."""
    cfg_j, params_j, cfg_t = smoke
    cfg_j = dataclasses.replace(cfg_j, chunked_ce=chunked_ce)
    cfg_t = dataclasses.replace(cfg_t, chunked_ce=chunked_ce)
    batch = _batch_np(cfg_j.vocab_size, step=1)
    (loss_j, met_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, cfg_j, b), has_aux=True))(
            params_j, _to_j(batch))
    params_t = _params_t(cfg_t, params_j)
    loss_t, met_t = tmodel.loss_fn(params_t, cfg_t, _to_t(batch))
    flat = ttransformer.flatten(params_t)
    grads_t = torch.autograd.grad(loss_t, list(flat.values()))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=LOSS_RTOL)
    for name in ("tokens", "perplexity"):
        np.testing.assert_allclose(float(met_t[name].detach()),
                                   float(met_j[name]),
                                   rtol=LOSS_RTOL)
    flat_j = _flatten_j(grads_j)
    for (k, _), g in zip(flat.items(), grads_t):
        _leaf_close(g.numpy(), flat_j[k], GRAD_TOL, k)


def test_remat_and_chunked_ce_keep_the_gradients(smoke):
    """remat="full" (recompute each block in the backward) and the chunked
    CE give the plain run's loss and gradients to fp32 rounding."""
    cfg_j, params_j, cfg_t = smoke
    batch = _to_t(_batch_np(cfg_t.vocab_size, step=2))
    params_t = _params_t(cfg_t, params_j)
    leaves = list(ttransformer.flatten(params_t).values())
    runs = []
    for remat, chunked in (("none", 0), ("full", 0), ("dots", 8)):
        cfg = dataclasses.replace(cfg_t, remat=remat, chunked_ce=chunked)
        loss, _ = tmodel.loss_fn(params_t, cfg, batch)
        runs.append((loss, torch.autograd.grad(loss, leaves)))
    for loss, grads in runs[1:]:
        torch.testing.assert_close(loss, runs[0][0], rtol=1e-6, atol=0)
        for g, g0 in zip(grads, runs[0][1]):
            torch.testing.assert_close(g, g0, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="remat policy"):
        ttransformer.remat_wrap(lambda x: x, "some")


# -- the train step -----------------------------------------------------------


OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=1.0)


@pytest.mark.parametrize("microbatch", [0, 1])
def test_three_train_steps_match_jax(smoke, microbatch):
    """Three make_train_step steps on SMOKE fp32 from bridged weights over
    the same batches: loss, grad norm and lr within 1e-4 relative each
    step; parameters after the third step within 1e-6 absolute (1.5e-7
    measured; each step moves a parameter by up to ~lr = 1e-3, and a
    gradient entry near zero, where Adam's update is ~sign(g), is where the
    two packages' rounding could disagree most)."""
    cfg_j, params_j, cfg_t = smoke
    step_j = jax.jit(jtrainer.make_train_step(
        cfg_j, JOptimizerConfig(**OPT), microbatch=microbatch))
    step_t = make_train_step(cfg_t, OptimizerConfig(**OPT),
                             microbatch=microbatch)
    opt_j = jadamw.adamw_init(params_j, JOptimizerConfig(**OPT))
    params_t = _params_t(cfg_t, params_j)
    opt_t = adamw_init(params_t, OptimizerConfig(**OPT))
    pj = params_j
    for step in range(3):
        batch = _batch_np(cfg_j.vocab_size, step=step)
        pj, opt_j, mj = step_j(pj, opt_j, _to_j(batch))
        params_t, opt_t, mt = step_t(params_t, opt_t, _to_t(batch))
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(mt[name]), float(mj[name]),
                                       rtol=LOSS_RTOL, err_msg=name)
    flat_j = _flatten_j(pj)
    for k, v in _np_tree(params_t).items():
        np.testing.assert_allclose(v, flat_j[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    assert int(opt_t["step"]) == 3


# -- checkpoints --------------------------------------------------------------


def _trained_state(cfg_t, params_j):
    params = _params_t(cfg_t, params_j)
    opt = adamw_init(params, OptimizerConfig(**OPT))
    step = make_train_step(cfg_t, OptimizerConfig(**OPT))
    params, opt, _ = step(params, opt, _to_t(_batch_np(cfg_t.vocab_size)))
    return params, opt


def test_port_checkpoint_restores_in_jax(smoke, tmp_path):
    cfg_j, params_j, cfg_t = smoke
    params_t, opt_t = _trained_state(cfg_t, params_j)
    path = Checkpointer(str(tmp_path)).save(
        1, {"params": params_t, "opt_state": opt_t},
        metadata={"data_state": {"seed": 0, "step": 1}})
    assert os.path.basename(path) == "step_00000001"
    tmpl = {"params": params_j,
            "opt_state": jadamw.adamw_init(params_j, JOptimizerConfig())}
    restored, meta = JCheckpointer(str(tmp_path)).restore(1, tmpl)
    assert meta == {"data_state": {"seed": 0, "step": 1}, "step": 1}
    for tree_t, tree_j in ((params_t, restored["params"]),
                           (opt_t["mu"], restored["opt_state"]["mu"])):
        flat_j = _flatten_j(tree_j)
        for k, v in _np_tree(tree_t).items():
            assert np.array_equal(v, flat_j[k]), k
    assert int(restored["opt_state"]["step"]) == 1
    flat = bridge.read_params_npz(path)
    again = bridge.params_from_flat(flat, cfg_t, device="cpu")
    for k, v in _np_tree(again).items():
        assert np.array_equal(v, _np_tree(params_t)[k]), k


def test_jax_checkpoint_restores_in_port(smoke, tmp_path):
    cfg_j, params_j, cfg_t = smoke
    opt_j = jadamw.adamw_init(params_j, JOptimizerConfig())
    opt_j = dict(opt_j, step=jnp.asarray(7, jnp.int32),
                 mu=jax.tree.map(lambda x: x + 0.5, opt_j["mu"]))
    JCheckpointer(str(tmp_path)).save(
        7, {"params": params_j, "opt_state": opt_j},
        metadata={"data_state": {"seed": 0, "step": 7}})
    tmpl_p = _params_t(cfg_t, params_j)
    tmpl = {"params": tmpl_p,
            "opt_state": adamw_init(tmpl_p, OptimizerConfig())}
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 7
    restored, meta = ck.restore(7, tmpl)
    assert meta["data_state"] == {"seed": 0, "step": 7}
    for tree_t, tree_j in ((restored["params"], params_j),
                           (restored["opt_state"]["mu"], opt_j["mu"])):
        flat_j = _flatten_j(tree_j)
        for k, v in _np_tree(tree_t).items():
            assert np.array_equal(v, flat_j[k]), k
    assert int(restored["opt_state"]["step"]) == 7
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(7, {"params": {"embed": {"tok": torch.zeros(3, 3)}}})


def test_bf16_checkpoint_widens_to_fp32(tmp_path):
    tree = {"a": {"w": torch.randn(3, 4).bfloat16()}}
    path = Checkpointer(str(tmp_path)).save(2, {"params": tree})
    with np.load(os.path.join(path, "params.npz")) as z:
        assert z["a/w"].dtype == np.float32
        assert np.array_equal(z["a/w"], tree["a"]["w"].float().numpy())
    with open(os.path.join(path, "metadata.json")) as f:
        assert json.load(f) == {"step": 2}
    back, _ = Checkpointer(str(tmp_path)).restore(2, {"params": tree})
    assert back["params"]["a"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["a"]["w"], tree["a"]["w"])


# -- the trainer and its launcher ---------------------------------------------


def _tcfg(tmp_path, steps, every=2):
    return TrainConfig(seq_len=S, global_batch=B, steps=steps, log_every=1,
                       checkpoint_every=every,
                       checkpoint_dir=str(tmp_path / "ck"),
                       optimizer=OptimizerConfig(**OPT))


def test_trainer_and_launcher_need_a_card_unless_told_cpu(smoke, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, _, cfg_t = smoke
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        Trainer(cfg_t, _tcfg(tmp_path, 1))
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        tlaunch.main(["--arch", "qwen3-8b", "--smoke", "--steps", "1",
                      "--ckpt-dir", str(tmp_path)])
    assert Trainer(cfg_t, _tcfg(tmp_path, 1), device="cpu").device.type \
        == "cpu"


def test_trainer_resumes_where_it_stopped(smoke, tmp_path):
    """A run preempted after step 3 resumes from its checkpoint and ends
    where an uninterrupted run ends: same data stream, same parameters."""
    _, _, cfg_t = smoke
    logs = []
    full = Trainer(cfg_t, _tcfg(tmp_path / "a", 5), device="cpu",
                   log_fn=logs.append)
    m_full = full.run()
    assert [h["step"] for h in full.history] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(h["loss"]) and h["tokens_per_s"] > 0
               for h in full.history)
    calls = iter(range(100))
    part = Trainer(cfg_t, _tcfg(tmp_path / "b", 5), device="cpu",
                   preempt_check=lambda: next(calls) == 2)
    assert part.run()["preempted_at"] == 3
    resumed = Trainer(cfg_t, _tcfg(tmp_path / "b", 5), device="cpu",
                      log_fn=logs.append)
    m_res = resumed.run()
    assert [h["step"] for h in resumed.history] == [4, 5]
    assert any("resumed from step 3" in line for line in logs)
    np.testing.assert_allclose(m_res["loss"], m_full["loss"], rtol=1e-6)
    for k, v in _np_tree(resumed._params).items():
        np.testing.assert_allclose(v, _np_tree(full._params)[k], atol=1e-6,
                                   err_msg=k)


def test_trainer_without_checkpoints_writes_nothing(smoke, tmp_path):
    _, _, cfg_t = smoke
    tcfg = _tcfg(tmp_path, 2, every=0)
    tr = Trainer(cfg_t, tcfg, device="cpu")
    tr.run()
    assert tr.ckpt is None and not os.path.exists(tcfg.checkpoint_dir)
    # compressed_pod_grads takes effect on a mesh with a pod dim only (as in
    # JAX, tests/test_torch_train_mesh.py); without one the step is plain
    tr = Trainer(cfg_t, dataclasses.replace(tcfg, compressed_pod_grads=True),
                 device="cpu")
    assert not tr.compressed
    assert tr.run()["loss"] == pytest.approx(
        Trainer(cfg_t, tcfg, device="cpu").run()["loss"], abs=0)


def test_launcher_trains_on_the_cpu(tmp_path):
    metrics = tlaunch.main(["--arch", "qwen3-8b", "--smoke", "--device",
                            "cpu", "--steps", "3", "--seq", "32", "--batch",
                            "2", "--ckpt-dir", str(tmp_path)])
    assert np.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    assert Checkpointer(str(tmp_path / "qwen3-8b")).latest_step() == 3


def test_launcher_cuts_depth_and_can_skip_checkpoints(tmp_path, monkeypatch):
    import repro_torch.train as ttrain
    made = []

    class Spy(ttrain.Trainer):
        def __init__(self, cfg, tcfg, **kw):
            made.append((cfg, tcfg))
            super().__init__(cfg, tcfg, **kw)

    monkeypatch.setattr(ttrain, "Trainer", Spy)
    metrics = tlaunch.main(["--arch", "qwen3-8b", "--smoke", "--device",
                            "cpu", "--layers", "1", "--steps", "2", "--seq",
                            "32", "--batch", "2", "--ckpt-every", "0",
                            "--ckpt-dir", str(tmp_path)])
    (cfg, tcfg), = made
    assert cfg.num_layers == 1 and tcfg.checkpoint_every == 0
    assert np.isfinite(metrics["loss"])
    assert not os.path.exists(tmp_path / "qwen3-8b")


def test_launcher_backend_routes_the_same_steps(tmp_path, monkeypatch):
    """--backend reference trains the same seeded steps through the plain
    reference forms: the losses of the default route (the kernels' plain
    twins on the CPU) within 1e-4 relative, and no kernel wrapper runs."""
    from repro_torch.kernels import blockwise_causal_attn as tbca
    import repro_torch.train as ttrain
    made = []

    class Spy(ttrain.Trainer):
        def __init__(self, cfg, tcfg, **kw):
            super().__init__(cfg, tcfg, **kw)
            made.append(self)

    monkeypatch.setattr(ttrain, "Trainer", Spy)
    args = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--steps",
            "2", "--seq", "32", "--batch", "2", "--ckpt-every", "0",
            "--ckpt-dir", str(tmp_path)]
    calls = []
    real = tbca.blockwise_causal_attn_plain
    monkeypatch.setattr(tbca, "blockwise_causal_attn_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tlaunch.main(args)
    n_auto = len(calls)
    tlaunch.main(args + ["--backend", "reference"])
    auto, ref = (np.array([h["loss"] for h in t.history]) for t in made)
    assert made[1].cfg.attention.backend == "reference"
    assert n_auto > 0 and len(calls) == n_auto
    np.testing.assert_allclose(ref, auto, rtol=1e-4)


def test_watchdog_flags_a_straggler(smoke, tmp_path):
    _, _, cfg_t = smoke
    logs = []
    tr = Trainer(cfg_t, _tcfg(tmp_path, 1, every=0), device="cpu",
                 log_fn=logs.append)
    tr.history = [{"ms": 100.0}] * 7
    tr._watchdog(7, 0.15)
    assert logs == []
    tr._watchdog(7, 0.25)
    assert len(logs) == 1 and "straggler" in logs[0]


def test_restore_reads_large_leaves_through_memory_maps(tmp_path):
    """A leaf above the memory-map threshold restores equal to the saved
    one, whole or through a transform that keeps a slice (a rank's shard,
    as the Trainer's restore on a mesh): the transform sees an np.memmap
    and only the slice is copied; small leaves are read whole."""
    w = torch.arange(300_000, dtype=torch.float32).reshape(600, 500)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, {"params": {"w": w, "b": torch.ones(3)}})
    seen = {}

    def cut(name, key, arr):
        seen[key] = type(arr)
        return np.ascontiguousarray(arr[100:200]) if key == "w" else arr

    part, _ = ckpt.restore(1, {"params": {"w": torch.zeros(100, 500),
                                          "b": torch.zeros(3)}},
                           transform=cut)
    assert seen["w"] is np.memmap and seen["b"] is not np.memmap
    assert torch.equal(part["params"]["w"], w[100:200])
    whole, _ = ckpt.restore(1, {"params": {"w": torch.zeros(600, 500),
                                           "b": torch.zeros(3)}})
    assert torch.equal(whole["params"]["w"], w)
    assert torch.equal(whole["params"]["b"], torch.ones(3))

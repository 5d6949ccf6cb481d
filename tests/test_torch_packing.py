"""Document packing and the "dots" remat policy: the PyTorch port against
the JAX package on the CPU.

Packing is numpy in both packages: `pack_documents`, `packing_efficiency`
and `FileCorpus` must return JAX's arrays exactly, and a train step on a
packed batch must match JAX's within test_torch_train.py's tolerances
(loss and grad norm 1e-4 relative; parameters after the step 1e-6
absolute). "dots" (JAX's dots_with_no_batch_dims_saveable: torch's
selective checkpointing saving aten.mm/addmm outputs) must give JAX's
remat="dots" gradients within 1e-5 of each leaf's largest entry, and keep
fewer bytes alive than no remat and more than full remat: the bytes
autograd saves (counted through saved_tensors_hooks) plus the matmul
outputs the policy caches."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.data import packing as jpack
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.train import trainer as jtrainer

from repro_torch import data as tdata
from repro_torch.checkpoint import bridge
from repro_torch.configs import config_from_dict
from repro_torch.configs.base import OptimizerConfig
from repro_torch.data import packing as tpack
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw_init
from repro_torch.train import make_train_step

LOSS_RTOL = 1e-4
GRAD_TOL = 1e-5
SEQ = 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's SMOKE-sized ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _docs(seed, n, lo=0, hi=80):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, 260, int(rng.integers(lo, hi))).astype(np.int64)
            for _ in range(n)]


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("mask_cross", [True, False])
@pytest.mark.parametrize("seed,n,hi", [(0, 12, 80), (1, 3, 200), (2, 40, 9),
                                       (3, 1, 5)])
def test_pack_documents_equals_jax(seed, n, hi, mask_cross):
    """Short, long (split over rows) and empty documents, a last row padded;
    tokens, labels and loss_mask equal JAX's; efficiency too."""
    docs = _docs(seed, n, hi=hi)
    got = tpack.pack_documents(docs, SEQ, mask_cross_document=mask_cross)
    want = jpack.pack_documents(docs, SEQ, mask_cross_document=mask_cross)
    _equal(got, want)
    assert tpack.packing_efficiency(got) == jpack.packing_efficiency(want)


def test_pack_nothing_equals_jax():
    _equal(tpack.pack_documents([], SEQ), jpack.pack_documents([], SEQ))
    assert tpack.packing_efficiency(tpack.pack_documents([], SEQ)) == 0.0
    assert tdata.pack_documents is tpack.pack_documents
    assert tdata.FileCorpus is tpack.FileCorpus


def _write_corpus(d, n, seed):
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "δέλτα", "epsilon", "zeta", "η"]
    for i in range(n):
        text = " ".join(rng.choice(words, int(rng.integers(2, 40))))
        (d / f"doc{i:02d}.txt").write_text(text, encoding="utf-8")
    (d / "notes.md").write_text("not a document")


def test_file_corpus_equals_jax(tmp_path):
    """Every batch of two epochs (the document order shuffles per epoch)
    equals JAX's; the vocab is the byte tokenizer's; a directory without a
    .txt file raises FileNotFoundError in both."""
    _write_corpus(tmp_path, 14, seed=0)
    got_c = tpack.FileCorpus(str(tmp_path), SEQ, seed=3)
    want_c = jpack.FileCorpus(str(tmp_path), SEQ, seed=3)
    assert got_c.vocab_size == want_c.vocab_size == 260
    for epoch in (0, 1):
        got = list(got_c.batches(2, epoch=epoch))
        want = list(want_c.batches(2, epoch=epoch))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            _equal(g, w)
    empty = tmp_path / "empty"
    empty.mkdir()
    for mod in (tpack, jpack):
        with pytest.raises(FileNotFoundError):
            mod.FileCorpus(str(empty), SEQ)


@pytest.fixture(scope="module")
def smoke():
    cfg_j = dataclasses.replace(jax_smoke_config("qwen3-8b"),
                                dtype="float32")
    params_j = jax.jit(lambda key: jmodel.init_params(key, cfg_j))(
        jax.random.PRNGKey(5))
    flat = {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params_j)[0]}
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    return cfg_j, params_j, cfg_t, flat


def _params_t(cfg_t, flat):
    params = bridge.params_from_flat(flat, cfg_t, device="cpu")
    for p in ttransformer.flatten(params).values():
        p.requires_grad_(True)
    return params


def _flat_j(tree):
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_train_step_on_a_packed_batch_matches_jax(smoke, tmp_path):
    """One make_train_step step on a FileCorpus batch (masked labels at
    document starts and padding): loss, grad norm, lr and the parameters
    after the step as in test_torch_train.py."""
    cfg_j, params_j, cfg_t, flat = smoke
    _write_corpus(tmp_path, 10, seed=1)
    batch = next(tpack.FileCorpus(str(tmp_path), 64, seed=0).batches(2))
    assert batch["loss_mask"].min() == 0
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=1.0)
    step_j = jax.jit(jtrainer.make_train_step(cfg_j, JOptimizerConfig(**opt)))
    pj, _, mj = step_j(params_j, jadamw.adamw_init(
        params_j, JOptimizerConfig(**opt)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params_t = _params_t(cfg_t, flat)
    params_t, _, mt = make_train_step(cfg_t, OptimizerConfig(**opt))(
        params_t, adamw_init(params_t, OptimizerConfig(**opt)),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for name in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(mt[name]), float(mj[name]),
                                   rtol=LOSS_RTOL, err_msg=name)
    flat_j = _flat_j(pj)
    for k, v in ttransformer.flatten(params_t).items():
        np.testing.assert_allclose(v.detach().numpy(), flat_j[k], atol=1e-6,
                                   rtol=0, err_msg=k)


def _packed_batch(cfg, seed=7):
    docs = _docs(seed, 8, lo=5, hi=40)
    docs = [d % cfg.vocab_size for d in docs]
    return tpack.pack_documents(docs, SEQ)


def test_dots_gradients_match_jax(smoke):
    """remat="dots" in both packages: the loss and every gradient leaf."""
    cfg_j, params_j, cfg_t, flat = smoke
    cfg_j = dataclasses.replace(cfg_j, remat="dots")
    cfg_t = dataclasses.replace(cfg_t, remat="dots")
    batch = _packed_batch(cfg_t)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, cfg_j, b), has_aux=True))(
            params_j, {k: jnp.asarray(v) for k, v in batch.items()})
    params_t = _params_t(cfg_t, flat)
    leaves = ttransformer.flatten(params_t)
    loss_t, _ = tmodel.loss_fn(params_t, cfg_t, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    grads_t = torch.autograd.grad(loss_t, list(leaves.values()))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=LOSS_RTOL)
    flat_j = _flat_j(grads_j)
    for (k, _), g in zip(leaves.items(), grads_t):
        want = flat_j[k]
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g.numpy(), want, atol=GRAD_TOL * scale,
                                   rtol=0, err_msg=k)


def _held_bytes(params, cfg, batch, monkeypatch):
    """Bytes a loss keeps for its backward: what autograd packs through
    saved_tensors_hooks outside any checkpoint, plus the outputs the
    "dots" policy caches (its selective-checkpoint storage)."""
    stores = []
    real = ttransformer.create_selective_checkpoint_contexts

    def spy(policy, *a, **k):
        fwd, rec = real(policy, *a, **k)
        stores.append(fwd.storage)
        return fwd, rec

    monkeypatch.setattr(ttransformer, "create_selective_checkpoint_contexts",
                        spy)
    packed = [0]

    def pack(t):
        packed[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = tmodel.loss_fn(params, cfg, batch)

    def nbytes(x):
        x = getattr(x, "val", x)
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        if isinstance(x, (tuple, list)):
            return sum(nbytes(y) for y in x)
        return 0

    cached = sum(nbytes(x) for st in stores for per_op in st.values()
                 for x in per_op.values())
    return loss, packed[0], cached, len(stores)


def test_dots_keeps_fewer_bytes_than_none_and_more_than_full(smoke,
                                                             monkeypatch):
    """Held bytes order none > dots > full at equal losses; "dots" caches
    only matmul outputs, one selective-checkpoint region a layer; every
    policy gives the same gradients."""
    _, _, cfg_t, flat = smoke
    params_t = _params_t(cfg_t, flat)
    leaves = list(ttransformer.flatten(params_t).values())
    batch = {k: torch.from_numpy(v)
             for k, v in _packed_batch(cfg_t, seed=8).items()}
    held, grads = {}, {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(cfg_t, remat=remat)
        loss, packed, cached, regions = _held_bytes(params_t, cfg, batch,
                                                    monkeypatch)
        assert regions == (cfg.num_layers if remat == "dots" else 0)
        assert (cached > 0) == (remat == "dots")
        held[remat] = packed + cached
        grads[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    assert held["none"] > held["dots"] > held["full"], held
    for remat in ("dots", "full"):
        torch.testing.assert_close(grads[remat][0], grads["none"][0],
                                   rtol=1e-6, atol=0)
        for g, g0 in zip(grads[remat][1], grads["none"][1]):
            torch.testing.assert_close(g, g0, rtol=1e-5, atol=1e-6)

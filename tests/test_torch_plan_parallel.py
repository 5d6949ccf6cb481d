"""The port's attention plan on a mesh: tensor-parallel (tp), sequence-
parallel (sp) and batch-sharded routes on gloo CPU ranks, against the JAX
package on one device.

One group of 4 gloo ranks (tests/torch_mesh_ranks.py) runs every case of
this module under the meshes data2×tp2, data2×sp2 and sp2×tp2 (sp4 for
`seq_parallel_linformer_attention`); on the CPU the plan's regions run the
kernels' plain twins per shard. The oracle is the JAX package in-process on
one device (backend "reference"), as JAX's own mesh tests hold its mesh
result to its single-device one; the tolerances are those tests': loss
1e-5, gradient leaves 1e-4·max(1, max|g|), outputs and float cache leaves
1e-5. Paged cache codes are held as tests/test_torch_paged.py holds them
(at most one quantization step: the fold sums in another order). Every
rank must end with the same whole tensors as rank 0. The comm byte
counters are held to the port's own cost model (core/seq_parallel.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import AttentionConfig, LinformerConfig, ModelConfig
from repro.core import cache as jcache
from repro.core import exact_linformer_attention as jexact
from repro.launch.mesh import validate_seq_shards as jvalidate_seq_shards
from repro.models import model as jmodel

from repro_torch.core.seq_parallel import (blockwise_sp_comm_bytes,
                                           seq_parallel_comm_bytes)

import torch_mesh_ranks

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
OUT_TOL = 1e-5
MESHES = tuple(torch_mesh_ranks.MESHES)
B, S = 4, 64
# the cache-level shapes of JAX's multi-device chunk-prefill/decode test
CB, CP, CH, CHKV, CDH, CC, CR, CMAX = 4, 16, 4, 2, 8, 8, 2, 64


def _cfg(hkv, backend="reference"):
    return ModelConfig(
        name="plan-parity", num_layers=2, d_model=32, vocab_size=256,
        max_seq_len=64,
        attention=AttentionConfig(
            kind="linformer_causal", num_heads=4, num_kv_heads=hkv,
            head_dim=8, backend=backend,
            linformer=LinformerConfig(block_size=8, block_slots=2)),
        dtype="float32", remat="full")


def _ecfg(backend="reference"):
    return ModelConfig(
        name="plan-exact", num_layers=2, d_model=32, vocab_size=256,
        max_seq_len=64, objective="mlm",
        attention=AttentionConfig(
            kind="linformer", num_heads=4, num_kv_heads=2, head_dim=8,
            causal=False, use_rope=False, backend=backend,
            linformer=LinformerConfig(k=16, sharing="layerwise")),
        dtype="float32", remat="none")


def _flatten_j(tree):
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _loss_grads_j(cfg, params, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, cfg, batch)[0]))
    loss, g = fn(params)
    return float(loss), _flatten_j(g)


def _np32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _paged_lc(rng, page_dtype):
    """One layer's paged cache of the cache-level case: row b owns pages
    b·8 .. b·8 + 7, random arena contents."""
    maxp = CMAX // CC
    npg = CB * maxp + 1
    pdt, qmax = jcache.resolve_page_dtype(page_dtype)
    lc = {"raw_k_q": jnp.zeros((CB, CC, CHKV, CDH), pdt),
          "raw_v_q": jnp.zeros((CB, CC, CHKV, CDH), pdt),
          "raw_k_s": jnp.zeros((CB, CC, CHKV), jnp.float32),
          "raw_v_s": jnp.zeros((CB, CC, CHKV), jnp.float32),
          "page_table": jnp.arange(CB * maxp, dtype=jnp.int32).reshape(
              CB, maxp)}
    for n in ("k", "v"):
        lc[f"page_{n}"], lc[f"page_{n}_s"] = jcache.quantize_blockwise(
            jnp.asarray(_np32(rng, npg, CR, CHKV, CDH, scale=0.1)), (1, 3),
            dtype=pdt, qmax=qmax)
    return lc


def _wire(lc):
    """A layer cache as the ranks load it: fp8 codes travel as bytes."""
    out = {}
    for k, v in lc.items():
        a = np.asarray(v)
        out[k] = (a.view(np.uint8).copy(), "fp8") \
            if a.dtype.itemsize == 1 and a.dtype != np.int8 else a.copy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX single-device results, each rank's results). The ranks run
    while JAX computes its oracle."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks,
             "loss_mask": np.ones((B, S), np.int32)}
    payload = {"batch": batch}
    params = {hkv: jmodel.init_params(jax.random.PRNGKey(hkv), _cfg(hkv))
              for hkv in (4, 2)}
    for hkv in (4, 2):
        payload[f"cfg{hkv}"] = dataclasses.asdict(_cfg(hkv, "auto"))
        payload[f"params{hkv}"] = _flatten_j(params[hkv])

    # cache level, at JAX's per-row offsets
    M = (CMAX // CC) * CR
    c = {"q": _np32(rng, CB, CP, CH, CDH), "k": _np32(rng, CB, CP, CHKV, CDH),
         "v": _np32(rng, CB, CP, CHKV, CDH),
         "E": _np32(rng, CC, CR, scale=0.3), "F": _np32(rng, CC, CR, scale=0.3),
         "t0": np.asarray([0, 8, 16, 24], np.int32),
         "td": np.asarray([3, 7, 12, 20], np.int32)}
    dense = {"raw_k": np.zeros((CB, CC, CHKV, CDH), np.float32),
             "raw_v": np.zeros((CB, CC, CHKV, CDH), np.float32),
             "comp_k": _np32(rng, CB, M, CHKV, CDH, scale=0.1),
             "comp_v": _np32(rng, CB, M, CHKV, CDH, scale=0.1)}
    lcs = {"dense": {k: jnp.asarray(v) for k, v in dense.items()},
           "int8": _paged_lc(rng, "int8"), "fp8": _paged_lc(rng, "fp8")}
    for fmt, lc in lcs.items():
        c[f"lc_{fmt}"] = _wire(lc)
    payload["cache"] = c

    ecfg = _ecfg()
    eparams = jmodel.init_params(jax.random.PRNGKey(7), ecfg)
    payload["ecfg"] = dataclasses.asdict(_ecfg("auto"))
    payload["eparams"] = _flatten_j(eparams)
    s = {"q": _np32(rng, 2, 64, 4, 8), "k": _np32(rng, 2, 64, 2, 8),
         "v": _np32(rng, 2, 64, 2, 8), "E": _np32(rng, 64, 16, scale=0.25),
         "F": _np32(rng, 64, 16, scale=0.25)}
    payload["sp4"] = s
    payload["bytes"] = {"q": _np32(rng, 2, 64, 4, 8),
                        "k": _np32(rng, 2, 64, 2, 8),
                        "v": _np32(rng, 2, 64, 2, 8),
                        "E": _np32(rng, 8, 2, scale=0.3),
                        "F": _np32(rng, 8, 2, scale=0.3),
                        "Ex": _np32(rng, 64, 16, scale=0.25)}
    finish = torch_mesh_ranks.start_ranks(
        tmp_path_factory.mktemp("plan_ranks"), "plan_cases", payload)

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = {("train", hkv): _loss_grads_j(_cfg(hkv), params[hkv], jbatch)
            for hkv in (4, 2)}
    jx = {n: jnp.asarray(c[n]) for n in
          ("q", "k", "v", "E", "F", "t0", "td")}
    for fmt, lc in lcs.items():
        prefill, decode = (
            (jcache.compressed_prefill_chunk,
             jcache.compressed_decode_attention) if fmt == "dense" else
            (jcache.paged_prefill_chunk, jcache.paged_decode_attention))
        o, lc1 = prefill(jx["q"], jx["k"], jx["v"], lc, jx["E"], jx["F"],
                         jx["t0"], plan="reference")
        do, lc2 = decode(jx["q"][:, :1], jx["k"][:, :1], jx["v"][:, :1], lc,
                         jx["E"], jx["F"], jx["td"], plan="reference")
        want[("cache", fmt)] = {"prefill": np.asarray(o),
                                "prefill_cache": _wire(lc1),
                                "decode": np.asarray(do),
                                "decode_cache": _wire(lc2)}
    want["exact"] = _loss_grads_j(ecfg, eparams, jbatch)
    want["sp4"] = np.asarray(jexact(*(jnp.asarray(s[n])
                                      for n in ("q", "k", "v", "E", "F"))))
    return want, finish()


def _grads_close(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k], w, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=f"{what}: {k}")


def _ranks_agree(got, key):
    """Every rank holds the same whole result as rank 0."""
    ref = got[0][key]
    for g in got[1:]:
        a, b = g[key], ref
        if isinstance(b, dict) and "grads" in b:
            assert abs(a["loss"] - b["loss"]) <= 1e-6
            a, b = a["grads"], b["grads"]
        flat_a = a if isinstance(a, dict) else {"": a}
        flat_b = b if isinstance(b, dict) else {"": b}
        for k in flat_b:
            x, y = flat_a[k], flat_b[k]
            if isinstance(y, dict):
                for kk in y:
                    np.testing.assert_allclose(x[kk], y[kk], atol=1e-6,
                                               rtol=0)
            else:
                np.testing.assert_allclose(x, y, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("hkv", [4, 2])
def test_train_loss_and_grads_match_jax(runs, hkv, mesh):
    """2 layers, remat "full": loss and every gradient leaf (E/F through
    the sharded backward) on the mesh against JAX single-device."""
    want, got = runs
    loss_j, grads_j = want[("train", hkv)]
    res = got[0][("train", hkv, mesh)]
    assert abs(res["loss"] - loss_j) < LOSS_TOL, (res["loss"], loss_j)
    _grads_close(res["grads"], grads_j, f"hkv={hkv} {mesh}")
    _ranks_agree(got, ("train", hkv, mesh))


def _ordinal(codes):
    """int8 codes, or fp8 e4m3 bits (sign-magnitude), as integers one
    quantization step apart."""
    x = codes.astype(np.int64)
    if codes.dtype == np.int8:
        return x
    return np.where(x & 0x80, -(x & 0x7F), x)


def _cache_leaf_close(got, want, what):
    if isinstance(want, tuple) or want.dtype == np.int8:
        want = want[0] if isinstance(want, tuple) else want
        assert np.abs(_ordinal(got) - _ordinal(want)).max() <= 1, what
    elif want.dtype == np.float32:
        np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("fmt", ["dense", "int8", "fp8"])
def test_chunk_prefill_and_decode_match_jax(runs, fmt, mesh):
    """Chunk prefill at per-row offsets t0 = 0, 8, 16, 24 and decode at
    td = 3, 7, 12, 20 (GQA) on the mesh: outputs and every cache leaf."""
    want, got = runs
    w, g = want[("cache", fmt)], got[0][("cache", fmt, mesh)]
    for step in ("prefill", "decode"):
        np.testing.assert_allclose(g[step], w[step], atol=OUT_TOL,
                                   rtol=OUT_TOL, err_msg=f"{fmt} {step}")
        cw, cg = w[f"{step}_cache"], g[f"{step}_cache"]
        assert sorted(cg) == sorted(cw)
        for k in cw:
            _cache_leaf_close(cg[k], cw[k], f"{fmt} {step} {k}")
    _ranks_agree(got, ("cache", fmt, mesh))


def test_exact_form_matches_jax_on_sp2_tp2(runs):
    """Exact form, layerwise-shared E, MLM: the kernel 6 / psum / kernel 5
    region (plain twins here) against JAX single-device."""
    want, got = runs
    loss_j, grads_j = want["exact"]
    res = got[0]["exact"]
    assert abs(res["loss"] - loss_j) < LOSS_TOL, (res["loss"], loss_j)
    _grads_close(res["grads"], grads_j, "exact sp2xtp2")
    _ranks_agree(got, "exact")


def test_seq_parallel_linformer_matches_exact_sp4(runs):
    want, got = runs
    np.testing.assert_allclose(got[0]["sp4"], want["sp4"], atol=1e-4,
                               rtol=0)
    _ranks_agree(got, "sp4")


def test_sp_refusal_has_jax_message(runs):
    with pytest.raises(ValueError) as e:
        jvalidate_seq_shards(24, 8, 2)
    for g in runs[1]:
        assert g["refusal"] == str(e.value)


def test_comm_bytes_match_cost_model(runs):
    """One layer on the CPU in fp32 (4 bytes): sp's all-gather of k̄/v̄
    under data2×sp2 (a batch row a shard, Hkv·Dh = 16) is
    blockwise_sp_comm_bytes's Linformer figure; the exact form's psum of
    k̄/v̄ under sp2×tp2 (one row, Hkv/tp·Dh = 8) is seq_parallel_comm_bytes's.
    No other collective runs in those forwards but the output gathers."""
    lin_causal, _ = blockwise_sp_comm_bytes(64, 8, 2, 2 * 8, 2, 4)
    lin_exact, _ = seq_parallel_comm_bytes(64, 16, 8, 2, 4)
    for g in runs[1]:
        assert g["bytes_causal"]["all_gather"] == lin_causal
        assert set(g["bytes_causal"]) == {"all_gather", "gather"}
        assert g["bytes_exact"]["psum"] == lin_exact
        assert set(g["bytes_exact"]) == {"psum", "gather"}


def test_reference_plan_opens_no_region(runs):
    """backend "reference" under sp2×tp2: no region, no collective, the
    plain form on the whole tensors."""
    for g in runs[1]:
        ref = g["reference"]
        assert ref["manual"] is False and ref["bytes"] == {}
        np.testing.assert_array_equal(ref["out"], runs[1][0]["reference"]
                                      ["out"])

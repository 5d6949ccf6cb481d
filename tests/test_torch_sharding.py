"""The port's sharding rules, int8 error-feedback helpers and cache specs
against the JAX package, in process (no ranks).

* `spec_for_path` / `param_shardings` for every leaf of every config's
  SMOKE parameters under each fsdp mode equal JAX's (its PartitionSpecs as
  tuples), the cases of JAX's `test_param_sharding_rules` included, and a
  rank's shard shape of each leaf is the leaf's dims over the product of
  the mesh widths its spec names.
* `quantize_int8`, `dequantize_int8`, `compress_with_feedback`,
  `decompress` and the stacked `compressed_pod_reduce` equal JAX's, the
  int8 codes bit for bit (both round half to even), on inputs that hold
  exact halves.
* `cache_pspecs` of the dense, full and paged pools equal JAX's plan's on
  a tp-2 mesh.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_IDS
from repro.configs import get_smoke_config
from repro.models import model as jmodel
from repro.optim import grad_utils as jgu
from repro.parallel.plan import AttentionPlan as JPlan
from repro.parallel.sharding import ParallelCtx as JCtx
from repro.parallel.sharding import param_shardings as jparam_shardings
from repro.parallel.sharding import spec_for_path as jspec_for_path
from repro.train.compressed_dp import compressed_pod_reduce as jreduce

from repro_torch.configs import config_from_dict
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.transformer import flatten, nest
from repro_torch.optim import grad_utils as tgu
from repro_torch.parallel.plan import AttentionPlan
from repro_torch.parallel.sharding import (Axis, ParallelCtx,
                                           param_shardings, shard_leaf,
                                           spec_for_path)
from repro_torch.train.compressed_dp import compressed_pod_reduce

FSDP_MODES = ("none", "data", "pod_data", "experts_data", "experts_pod_data")
ARCHS = sorted(ALL_IDS)


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


class _Mesh:
    """A DeviceMesh stand-in: dim names and widths, this rank at 0."""

    def __init__(self, names, widths):
        self.mesh_dim_names, self.widths = tuple(names), tuple(widths)

    def size(self, i):
        return self.widths[i]

    def get_local_rank(self, name):
        return 0

    def get_group(self, name):
        return None


def _jflat(tree):
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


@pytest.fixture(scope="module")
def shapes():
    """{arch: (JAX's SMOKE parameter shapes, the port's param_spec)}."""
    out = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        jshapes = jax.eval_shape(
            lambda c=cfg: jmodel.init_params(jax.random.PRNGKey(0), c))
        tspec = tmodel.param_spec(config_from_dict(dataclasses.asdict(cfg)))
        out[arch] = (jshapes, nest({k: _Shape(v[0])
                                    for k, v in tspec.items()}))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_as_jax(shapes, arch):
    jshapes, tshapes = shapes[arch]
    for fsdp in FSDP_MODES:
        want = {k: tuple(v) for k, v in _jflat(jparam_shardings(
            jshapes, JCtx(fsdp=fsdp))).items()}
        got = flatten(param_shardings(tshapes, ParallelCtx(fsdp=fsdp)))
        assert got == want, (arch, fsdp)


def test_param_sharding_rules_as_jax():
    """JAX's test_param_sharding_rules cases, and the rule of each path
    against JAX's at every rank it can take."""
    cases = [("layers/attn/wq", ("data",), 3),
             ("layers/attn/wo", ("data",), 3),
             ("layers/moe/w_in", ("data",), 4), ("embed/tok", (), 2),
             ("lm_head", ("pod", "data"), 2),
             ("shared_block/attn/wq", (), 2), ("shared/lin/E", ("data",), 2),
             ("layers/rwkv/w_r", ("data",), 3),
             ("layers/moe/router", ("pod", "data"), 3),
             ("trunk/ssm/w_out", ("data",), 3), ("embed/pos", ("data",), 2),
             ("layers/attn/bq", ("data",), 2)]
    for path, fsdp, nd in cases:
        for scope in ("all", "moe"):
            for ndim in (nd - 1, nd, nd + 1):
                assert spec_for_path(path, fsdp, ndim, scope) == tuple(
                    jspec_for_path(path, fsdp, ndim, scope)), (path, ndim)
    assert spec_for_path("layers/attn/wq", ("data",), 3) == \
        (None, "data", "model")
    assert spec_for_path("lm_head", ("pod", "data"), 2) == \
        (("pod", "data"), "model")


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen3-moe-30b-a3b",
                                  "zamba2-1.2b", "rwkv6-1.6b"])
def test_local_shard_shapes(shapes, arch):
    """A rank's shard of each leaf on pod2 × data2 × model2 (fsdp
    "pod_data"): each dim over the product of the widths its spec names."""
    _, tshapes = shapes[arch]
    widths = {"pod": 2, "data": 2, "model": 2}
    ctx = ParallelCtx(mesh=_Mesh(widths, widths.values()), fsdp="pod_data")
    specs = flatten(param_shardings(tshapes, ctx))
    for key, leaf in flatten(tshapes).items():
        spec = specs[key]
        want = []
        for n, entry in zip(leaf.shape, spec):
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            want.append(n // int(np.prod([widths[a] for a in names])))
        got = shard_leaf(torch.empty(leaf.shape), spec, ctx).shape
        assert tuple(got) == tuple(want), key


def _halves(shape, seed):
    """fp32 values with exact .5 ratios to their amax / 127 (the rounding
    ties), negative and positive, beside random ones."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[0] = 127.0
    x.reshape(-1)[1:6] = [0.5, -0.5, 1.5, -2.5, 3.5]
    return x


def test_int8_helpers_as_jax():
    for seed, shape in enumerate([(7,), (3, 5), (2, 3, 4)]):
        x = _halves(shape, seed)
        qj, sj = jgu.quantize_int8(jnp.asarray(x))
        qt, st = tgu.quantize_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert float(st) == float(sj)
        np.testing.assert_array_equal(
            tgu.dequantize_int8(qt, st).numpy(),
            np.asarray(jgu.dequantize_int8(qj, sj)))
    grads = {"a": _halves((4, 3), 5), "b": {"c": _halves((6,), 6)}}
    res = {"a": _halves((4, 3), 7) * 0.01, "b": {"c": _halves((6,), 8)}}
    for r in (None, res):
        cj, rj = jgu.compress_with_feedback(
            jax.tree.map(jnp.asarray, grads),
            None if r is None else jax.tree.map(jnp.asarray, r))
        ct, rt = tgu.compress_with_feedback(
            jax.tree.map(torch.from_numpy, grads),
            None if r is None else jax.tree.map(torch.from_numpy, r))
        for k, leaf in flatten(ct).items():
            want = np.asarray(_jflat(cj)[k])
            np.testing.assert_array_equal(leaf.numpy(), want, k)
        for k, leaf in flatten(rt).items():
            np.testing.assert_array_equal(leaf.numpy(),
                                          np.asarray(_jflat(rj)[k]), k)
        for k, leaf in flatten(tgu.decompress(ct)).items():
            np.testing.assert_array_equal(
                leaf.numpy(), np.asarray(_jflat(jgu.decompress(cj))[k]), k)


def test_compressed_pod_reduce_as_jax():
    gp = {"w": np.stack([_halves((5, 4), 1), _halves((5, 4), 2) * 3]),
          "b": np.stack([_halves((9,), 3), _halves((9,), 4) * 0.1])}
    rp = jax.tree.map(lambda g: (g * 0.01).astype(np.float32), gp)
    red_j, res_j = jreduce(jax.tree.map(jnp.asarray, gp),
                           jax.tree.map(jnp.asarray, rp), 2)
    red_t, res_t = compressed_pod_reduce(
        jax.tree.map(torch.from_numpy, gp),
        jax.tree.map(torch.from_numpy, rp), 2)
    for k in gp:
        np.testing.assert_array_equal(red_t[k].numpy(), np.asarray(red_j[k]))
        np.testing.assert_array_equal(res_t[k].numpy(), np.asarray(res_j[k]))


class _JMesh:
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 2}


@pytest.mark.parametrize("kind", ["dense", "full", "paged"])
def test_cache_pspecs_as_jax(kind):
    cfg = get_smoke_config("qwen3-8b")
    a = config_from_dict(dataclasses.asdict(cfg)).attention
    if kind == "paged":
        spec = tattn.paged_decode_cache_spec(a, num_layers=2, batch=3,
                                             max_seq=64, arena_pages=9,
                                             page_dtype="int8")
    else:
        if kind == "full":
            a = dataclasses.replace(a, kind="standard")
        spec = tattn.decode_cache_spec(a, num_layers=2, batch=3, max_seq=64,
                                       dtype=torch.float32)
    cache = {k: _Shape(shape) for k, (shape, _) in spec.items()}
    tplan = AttentionPlan(tp_dim=Axis("model", 2, 0, None))
    jplan = JPlan(backend="fused", mesh=_JMesh(), tp_axis="model")
    want = {k: tuple(v) for k, v in jplan.cache_pspecs(cache).items()}
    assert tplan.cache_pspecs(cache) == want
    assert AttentionPlan().cache_pspecs(cache) == {
        k: (None,) * len(v.shape) for k, v in cache.items()}


def _segments(cfg):
    """JAX's `_split_proj` segments of Mamba2's w_in, as the whole leaf's
    column indices: a one-hot input against a w_in whose first row counts
    the columns."""
    from repro.models import mamba2 as jm2
    d_inner, H, _ = jm2.dims(cfg.d_model, cfg.ssm)
    W = 2 * d_inner + 2 * cfg.ssm.state_dim + H
    w_in = jnp.zeros((cfg.d_model, W)).at[0].set(jnp.arange(W))
    x = jnp.zeros((1, cfg.d_model)).at[0, 0].set(1.0)
    names = ("z", "x", "B", "C", "dt")
    return dict(zip(names, (np.asarray(s[0]).astype(int).tolist() for s in
                            jm2._split_proj({"w_in": w_in}, x, cfg.ssm,
                                            cfg.d_model))))


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_mamba_in_columns_cover_jax_split(smoke, tp):
    """Each rank's z, x and dt columns of the whole ssm/w_in (its heads,
    head_range) joined in rank order are JAX's z, x and dt segments
    exactly, and every rank reads all of B and C."""
    from repro.configs import get_config
    from repro_torch.parallel.sharding import head_range, mamba_in_columns
    cfg = (get_smoke_config if smoke else get_config)("zamba2-1.2b")
    want = _segments(cfg)
    d_inner = cfg.ssm.expand * cfg.d_model
    P_ = cfg.ssm.head_dim
    H = d_inner // P_
    got = {k: [] for k in want}
    for coord in range(tp):
        heads = head_range(H, Axis("model", tp, coord, None))
        assert heads == (coord * H // tp, (coord + 1) * H // tp)
        cols = mamba_in_columns(d_inner, cfg.ssm.state_dim, P_, heads)
        assert list(cols) == list(want)
        for k in ("z", "x", "dt"):
            got[k] += list(cols[k])
        for k in ("B", "C"):
            assert list(cols[k]) == want[k]
    for k in ("z", "x", "dt"):
        assert got[k] == want[k], k


def test_ssm_gathered_route_where_width_does_not_divide_heads():
    """Where the model width does not divide the Mamba2 or RWKV6 heads the
    family takes the gathered route: no head range, every ssm/ and rwkv/
    leaf gathered whole inside the block (tp_keep), and the models run
    their blocks without tp; where it divides, each leaf whose rule names
    the model dim keeps it."""
    from repro_torch.configs import get_smoke_config as tsmoke
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import rwkv_model, zamba
    from repro_torch.parallel.sharding import head_range, tp_keep
    assert head_range(2, Axis("model", 4, 1, None)) is None
    assert head_range(4, Axis("model", 4, 1, None)) == (1, 2)
    assert head_range(4, None) is None
    rwkv = tsmoke("rwkv6-1.6b")
    two_heads = dataclasses.replace(rwkv, rwkv=dataclasses.replace(
        rwkv.rwkv, head_dim=32))
    zam = tsmoke("zamba2-1.2b")
    two_ssm = dataclasses.replace(zam, ssm=dataclasses.replace(
        zam.ssm, head_dim=64))
    with mesh_lib.fake_world(4):
        mesh = mesh_lib.make_mesh((4,), ("model",), device_type="cpu")
        ctx = ParallelCtx(mesh=mesh, fsdp="data", sharded=True)
        tp = ctx.axis("model")
        assert rwkv_model.ssm_axis(rwkv, ctx) == (tp, False)
        assert rwkv_model.ssm_axis(two_heads, ctx) == (None, True)
        assert zamba.ssm_axis(zam, ctx) == (tp, False)
        assert zamba.ssm_axis(two_ssm, ctx) == (None, True)
        for path in ("layers/rwkv/w_r", "layers/rwkv/cm_w_r",
                     "trunk/ssm/w_in", "trunk/ssm/w_out"):
            assert tp_keep(path, ctx) == ("model",)
            assert tp_keep(path, ctx, whole_ssm=True) == ()
        assert tp_keep("shared_block/mlp/w_in", ctx,
                       whole_ssm=True) == ("model",)

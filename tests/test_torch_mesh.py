"""The port's mesh helpers, parallel context and plan resolution, in process
against the JAX package's (launch/mesh.py, parallel/sharding.py,
parallel/plan.py).

The checks and the resolution read only a mesh's dim names and widths, so
they run here on stand-in meshes of any shape (a torch-style one for the
port, a JAX-style one for JAX); `ParallelCtx` is also built on a real
DeviceMesh over a 1-rank gloo group.
"""
import dataclasses
import warnings

import pytest
import torch

from repro.configs.base import AttentionConfig as JAttentionConfig
from repro.launch import mesh as jmesh
from repro.parallel import plan as jplan
from repro.parallel.sharding import ParallelCtx as JParallelCtx

from repro_torch.configs.base import AttentionConfig, LinformerConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.parallel import plan as tplan
from repro_torch.parallel.sharding import ParallelCtx


@dataclasses.dataclass(frozen=True)
class TorchMesh:
    """A DeviceMesh stand-in: dim names and widths; this rank at
    coordinate 0 of every dim, no process groups."""
    names: tuple
    widths: tuple

    @property
    def mesh_dim_names(self):
        return self.names

    def size(self, i):
        return self.widths[i]

    def get_local_rank(self, name):
        return 0

    def get_group(self, name):
        return None


@dataclasses.dataclass(frozen=True)
class JaxMesh:
    """A jax.sharding.Mesh stand-in for the JAX package's checks."""
    axis_names: tuple
    widths: tuple

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.widths))


def _meshes(names, widths):
    return TorchMesh(names, widths), JaxMesh(names, widths)


SHAPES = [(("data", "model"), (1, 1)), (("data", "model"), (2, 3)),
          (("data", "seq", "model"), (1, 2, 2)),
          (("pod", "data", "model"), (2, 2, 4))]


def _warned(fn):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(x.message) for x in w]


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("tp,hkv", [(1, 4), (2, 4), (3, 4), (4, 2), (8, 8)])
def test_validate_attention_mesh_as_jax(tp, hkv, strict):
    tm, jm = _meshes(("data", "model"), (1, tp))
    kw = dict(num_heads=2 * hkv, num_kv_heads=hkv, strict=strict)
    results = []
    for fn, m in ((tmesh.validate_attention_mesh, tm),
                  (jmesh.validate_attention_mesh, jm)):
        try:
            results.append(("ok",) + _warned(lambda: fn(m, **kw)))
        except ValueError as e:
            results.append(("raised", str(e)))
    assert results[0] == results[1]
    assert (results[0][0] == "raised") == (strict and hkv % tp != 0)


@pytest.mark.parametrize("seq,block,sp", [(64, 8, 2), (24, 8, 2),
                                          (4096, 256, 2), (4096, 256, 3),
                                          (512, 256, 4)])
def test_validate_seq_shards_as_jax(seq, block, sp):
    errs = []
    for fn in (tmesh.validate_seq_shards, jmesh.validate_seq_shards):
        try:
            fn(seq, block, sp)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]
    assert (errs[0] is None) == (seq % (sp * block) == 0)


def test_fsdp_policy_as_jax():
    assert tmesh.ARCH_FSDP == jmesh.ARCH_FSDP
    for arch in list(jmesh.ARCH_FSDP) + ["no-such-arch"]:
        for multi_pod in (False, True):
            assert tmesh.fsdp_for(arch, multi_pod) == \
                jmesh.fsdp_for(arch, multi_pod)


@pytest.mark.parametrize("fsdp", ["none", "data", "pod_data",
                                  "experts_data", "experts_pod_data"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_parallel_ctx_properties_as_jax(shape, fsdp):
    tm, jm = _meshes(*shape)
    for excl in ((), ("data",)):
        t = ParallelCtx(mesh=tm, fsdp=fsdp, exclude_data_axes=excl)
        j = JParallelCtx(mesh=jm, fsdp=fsdp, exclude_data_axes=excl)
        for prop in ("data_axes", "fsdp_axes", "fsdp_scope", "has_pod_axis",
                     "model_shards", "seq_shards"):
            assert getattr(t, prop) == getattr(j, prop), prop
        for name, width in zip(*shape):
            a = t.axis(name)
            assert (a.name, a.width, a.coord) == (name, width, 0)
    t, j = ParallelCtx(), JParallelCtx()
    for prop in ("data_axes", "fsdp_axes", "has_pod_axis", "model_shards",
                 "seq_shards"):
        assert getattr(t, prop) == getattr(j, prop), prop


@pytest.fixture
def one_rank(tmp_path):
    import torch.distributed as dist
    tmesh.init_ranks("gloo", f"file://{tmp_path}/rendezvous", 0, 1)
    yield
    dist.destroy_process_group()


def test_parallel_ctx_on_a_one_rank_gloo_mesh(one_rank):
    """A real DeviceMesh over one gloo rank: JAX's 2-axis shape, widths 1,
    and the shards refusal of a world that does not divide."""
    mesh = tmesh.make_local_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    ctx = ParallelCtx(mesh=mesh, fsdp="data")
    assert (ctx.data_axes, ctx.fsdp_axes, ctx.model_shards, ctx.seq_shards,
            ctx.has_pod_axis) == (("data",), ("data",), 1, 1, False)
    a = ctx.axis("model")
    assert (a.width, a.coord) == (1, 0) and a.group is not None
    assert hash(ctx) == hash(ParallelCtx(mesh=mesh, fsdp="data"))
    plan = tplan.resolve_attention_plan(AttentionConfig(), ctx)
    assert (plan.tp, plan.sp, plan.manual) == (1, 1, False)
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.make_local_mesh(2, device_type="cpu")


def test_plan_on_a_rebuilt_mesh_holds_the_new_groups(tmp_path):
    """After the groups are destroyed and opened again, a mesh of the same
    shape (equal to the old one as torch compares meshes) gets a new ctx
    and a new plan, whose dims hold the new process groups."""
    import torch.distributed as dist
    acfg = AttentionConfig()
    found = []
    for i in range(2):
        tmesh.init_ranks("gloo", f"file://{tmp_path}/rendezvous{i}", 0, 1)
        try:
            mesh = tmesh.make_local_mesh(device_type="cpu")
            ctx = ParallelCtx(mesh=mesh)
            plan = tplan.resolve_attention_plan(acfg, ctx)
            assert plan is tplan.resolve_attention_plan(
                acfg, ParallelCtx(mesh=mesh))
            assert [a.group for a in plan.data_dims] == \
                [mesh.get_group("data")]
            found.append((ctx, plan))
        finally:
            dist.destroy_process_group()
    (ctx0, plan0), (ctx1, plan1) = found
    assert ctx0 != ctx1 and plan0 is not plan1
    assert plan0.data_dims[0].group is not plan1.data_dims[0].group


def _acfg(hkv, backend="auto"):
    return dict(num_heads=2 * hkv, num_kv_heads=hkv, backend=backend)


@pytest.mark.parametrize("backend,jbackend", [("auto", "fused"),
                                              ("reference", "reference")])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_resolution_as_jax(shape, backend, jbackend):
    """tp and sp dims, data dims, `manual`, the tp drop on an indivisible
    Hkv (with JAX's warning), and the cache per (config, ctx)."""
    tm, jm = _meshes(*shape)
    # head_dim picks a config no other case resolves: the warning fires
    # on the first resolution only (cached)
    acfg = AttentionConfig(**_acfg(4, backend), head_dim=16 + sum(shape[1]))
    jacfg = JAttentionConfig(**_acfg(4, jbackend), head_dim=16 + sum(shape[1]))
    ctx, jctx = ParallelCtx(mesh=tm), JParallelCtx(mesh=jm)
    t, tw = _warned(lambda: tplan.resolve_attention_plan(acfg, ctx))
    j, jw = _warned(lambda: jplan.resolve_attention_plan(jacfg, jctx))
    assert tw == jw
    for prop in ("tp_axis", "sp_axis", "data_axes", "tp", "sp", "manual"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert tplan.resolve_attention_plan(acfg, ctx) is t
    assert tplan.resolve_attention_plan(acfg, ParallelCtx(mesh=tm)) is t
    for B in (1, 2, 4, 6, 8):
        assert _names(t._batch_axes(B)) == j._batch_axes(B), B
    if t.sp > 1:
        assert _names(t._sp_for(64, 8, required=False)) == \
            (j._sp_for(64, 8, required=False),)


def _names(axes):
    """The port's region entry (Axis records) as JAX's (dim names, None for
    a whole dim)."""
    return tuple(a.name for a in axes) or None


def test_plan_drops_tp_with_warning_on_indivisible_hkv():
    tm, _ = _meshes(("data", "model"), (1, 3))
    acfg = AttentionConfig(**_acfg(4), head_dim=24)
    plan, w = _warned(lambda: tplan.resolve_attention_plan(
        acfg, ParallelCtx(mesh=tm)))
    assert plan.tp_axis is None and plan.tp == 1 and not plan.manual
    assert len(w) == 1 and "does not divide num_kv_heads=4" in w[0]
    _, again = _warned(lambda: tplan.resolve_attention_plan(
        acfg, ParallelCtx(mesh=tm)))
    assert again == []                      # cached: resolved once


def test_reference_plan_opens_no_region():
    """"reference" under an sp2 × tp2 mesh runs the plain form on whole
    tensors: no collective (the stand-in mesh has no process groups, so a
    region would fail), the single-device result; "auto" is manual."""
    tm, _ = _meshes(("data", "seq", "model"), (1, 2, 2))
    lin = LinformerConfig(block_size=8, block_slots=2)
    ref = tplan.resolve_attention_plan(
        AttentionConfig(**_acfg(2, "reference"), head_dim=8, linformer=lin),
        ParallelCtx(mesh=tm))
    auto = tplan.resolve_attention_plan(
        AttentionConfig(**_acfg(2), head_dim=8, linformer=lin),
        ParallelCtx(mesh=tm))
    assert not ref.manual and auto.manual and ref.sp == 2 and ref.tp == 2
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 32, 4, 8, generator=g)
    k, v = torch.randn(2, 2, 32, 2, 8, generator=g)
    E, F = torch.randn(2, 8, 2, generator=g) * 0.3
    kw = dict(block_size=8, block_slots=2, scale=0.5)
    want = tplan.AttentionPlan(backend="reference").causal_attention(
        q, k, v, E, F, **kw)
    torch.testing.assert_close(ref.causal_attention(q, k, v, E, F, **kw),
                               want, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_ssm_and_hybrid_refuse_a_mesh_ctx(arch):
    """They refused a mesh ctx until sharded training came; now they take
    one: forward, loss and decode under a ctx whose mesh dims are all 1
    wide (no collective runs) equal the single-device ones, and so does
    forward under a ctx without a mesh. Their multi-rank runs are
    tests/test_torch_train_mesh.py's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as tmodel
    cfg = get_smoke_config(arch)
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    toks = torch.zeros(1, 16, dtype=torch.long)
    batch = {"tokens": toks, "labels": toks,
             "loss_mask": torch.ones(1, 16, dtype=torch.int32)}
    want, _, _ = tmodel.forward(params, cfg, {"tokens": toks})
    want_loss, _ = tmodel.loss_fn(params, cfg, batch)
    cache = tmodel.init_cache(cfg, batch=1, max_seq=32, device="cpu")

    def fresh(c):
        return {k: fresh(v) if isinstance(v, dict) else v.clone()
                for k, v in c.items()}

    want_step, _ = tmodel.decode_step(params, cfg, toks[:, :1], fresh(cache))
    for ctx in (ParallelCtx(mesh=TorchMesh(("data", "model"), (1, 1))),
                ParallelCtx(mesh=TorchMesh(("data", "model"), (1, 1)),
                            sharded=True),
                ParallelCtx()):
        got, _, _ = tmodel.forward(params, cfg, {"tokens": toks}, ctx=ctx)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        loss, _ = tmodel.loss_fn(params, cfg, batch, ctx=ctx)
        torch.testing.assert_close(loss, want_loss, rtol=0, atol=0)
        step, _ = tmodel.decode_step(params, cfg, toks[:, :1], fresh(cache),
                                     ctx=ctx)
        torch.testing.assert_close(step, want_step, rtol=0, atol=0)

"""The port's dry run (repro_torch/launch/dryrun.py, step_cost.py,
specs.py) and the kernels' fake path, on the CPU.

A SMOKE train cell on a fake 4-rank mesh (data 2 × model 2) must count its
argument bytes as the sum of this rank's shards per JAX's sharding rules;
`model_flops_per_chip` must be JAX's formula from JAX's own config; a
4-layer step must count exactly the collectives and FLOPs of a 1-layer
step plus three times those of one layer (eager execution counts every
layer: the counterpart of `test_hlo_cost_analyzer_counts_loop_collectives`);
every kernel wrapper's fake path must give the shapes and dtypes of its
plain twin, report one launch with its cost function's numbers to the
cost sink and leave the launch counters (which count kernels launched)
alone; a
real CPU tensor must still reach the plain twin.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_config
from repro.parallel.sharding import spec_for_path
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import SHAPES, OptimizerConfig, ShapeConfig
from repro_torch.kernels import blockwise_causal_attn as bca
from repro_torch.kernels import common
from repro_torch.kernels import linformer_attn as la
from repro_torch.kernels import seq_projection as sp
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.step_cost import measure
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import flatten
from repro_torch.optim import adamw_init
from repro_torch.parallel.sharding import ParallelCtx
from repro_torch.train.trainer import make_train_step

WIDTHS = {"data": 2, "model": 2}
TRAIN = ShapeConfig("train_smoke", 32, 8, "train")


@pytest.fixture
def fake_ctx():
    """A fake world of 4 ranks, data 2 × model 2 (a fake group costs
    milliseconds; it is process-global, and `run_cell` makes its own)."""
    with mesh_lib.fake_world(4):
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"),
                                  device_type="cpu")
        yield ParallelCtx(mesh=mesh, fsdp="data")


def _smoke(layers=2):
    return dataclasses.replace(get_smoke_config("qwen3-8b"),
                               num_layers=layers)


def _local(shape, spec):
    out = []
    for n, e in zip(shape, tuple(spec) + (None,) * len(shape)):
        names = (e,) if isinstance(e, str) else tuple(e or ())
        out.append(n // int(np.prod([WIDTHS[a] for a in names])))
    return out


def test_smoke_cell_argument_bytes_are_the_shards(fake_ctx):
    cfg = _smoke()
    rec = dryrun.dry_run(cfg, TRAIN, fake_ctx, device="cpu")
    want_params = want_moments = 0
    for key, (shape, _, dtype) in model_lib.param_spec(cfg).items():
        n = int(np.prod(_local(shape, spec_for_path(key, ("data",),
                                                    len(shape)))))
        want_params += n * torch.empty((), dtype=dtype).element_size()
        want_moments += 2 * n * 4                        # fp32 mu and nu
    want_batch = 3 * TRAIN.global_batch * TRAIN.seq_len * 4   # int32
    parts = rec["argument_bytes_by_part"]
    assert parts == {"params": want_params, "moments": want_moments,
                     "batch": want_batch}
    assert rec["argument_bytes"] == want_params + want_moments + want_batch
    assert rec["peak_bytes"] >= rec["argument_bytes"]
    assert rec["bytes_lower"] <= rec["bytes_upper"]
    assert rec["aten_flops"] > 0 and rec["kernel_flops"] > 0
    L = cfg.num_layers
    assert {k: v["launches"] for k, v in rec["kernels"].items()} == {
        "blockwise_causal_attn(return_residuals)": L,
        "blockwise_causal_attn_bwd": L}


@pytest.mark.parametrize("arch", dryrun.ARCH_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s.name)
def test_model_flops_per_chip_is_jax_formula(arch, shape):
    jcfg = jax_config(arch)
    tokens = shape.global_batch * (shape.seq_len if shape.kind in
                                   ("train", "prefill") else 1)
    mult = 6 if shape.kind == "train" else 2
    for chips in (256, 512):
        want = mult * jcfg.active_param_count_estimate * tokens / chips
        got = dryrun.model_flops_per_chip(dryrun.configure(arch), shape,
                                          chips)
        assert got == want


def test_layers_count_linearly(fake_ctx):
    """Each layer's collectives (the FSDP gathers of its weights, the
    gradients' reductions) and FLOPs are counted once per layer."""
    recs = {L: dryrun.dry_run(_smoke(L), TRAIN, fake_ctx, device="cpu")
            for L in (1, 2, 4)}

    def counts(r):
        out = {"flops": r["flops"], "aten_flops": r["aten_flops"],
               "kernel_flops": r["kernel_flops"]}
        for op, c in r["collectives"].items():
            out[f"{op} bytes"], out[f"{op} calls"] = c["bytes"], c["calls"]
        return out

    c1, c2, c4 = (counts(recs[L]) for L in (1, 2, 4))
    assert set(c1) == set(c2) == set(c4)
    for k in c1:
        assert c4[k] - c1[k] == 3 * (c2[k] - c1[k]), k
    assert c2["flops"] > c1["flops"]
    assert c2["all_gather calls"] > c1["all_gather calls"]
    assert recs[4]["kernels"]["blockwise_causal_attn_bwd"]["launches"] == 4


def _mlp_and_head_flops(monkeypatch, cfg, ctx):
    """The forward FLOPs of the MLPs and of the head in a dry-run train
    step of `cfg` on `ctx` (None: world size 1), each call counted by a
    FlopCounterMode of its own."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import layers, transformer
    got = {"mlp": 0, "head": 0}

    def counted(part, fn):
        def wrapped(*args, **kw):
            with FlopCounterMode(display=False) as fc:
                out = fn(*args, **kw)
            got[part] += fc.get_total_flops()
            return out
        return wrapped

    monkeypatch.setattr(layers, "apply_mlp",
                        counted("mlp", layers.apply_mlp))
    monkeypatch.setattr(transformer, "logits_from_hidden",
                        counted("head", transformer.logits_from_hidden))
    dryrun.dry_run(cfg, TRAIN, ctx, device="cpu")
    monkeypatch.undo()
    return got


@pytest.mark.parametrize("tp", [2, 4])
def test_tensor_parallel_step_divides_mlp_and_head_flops(monkeypatch, tp):
    """On a fake model dim of `tp` ranks (no data dim: each rank sees the
    whole batch) the MLP and head matmuls of a sharded train step take
    1/tp of world size 1's FLOPs a device (at tp 4 the attention takes
    the whole-head route, two KV heads; the MLP and head stay split)."""
    cfg = _smoke()
    one = _mlp_and_head_flops(monkeypatch, cfg, None)
    with mesh_lib.fake_world(tp):
        ctx = ParallelCtx(mesh=mesh_lib.make_mesh((tp,), ("model",),
                                                  device_type="cpu"),
                          fsdp="data")
        got = _mlp_and_head_flops(monkeypatch, cfg, ctx)
    assert one["mlp"] > 0 and one["head"] > 0
    assert got == {k: v // tp for k, v in one.items()}, (got, one)


# -- the kernels' fake path ---------------------------------------------------

B, H, HKV, S, C, R, DH = 2, 4, 2, 32, 16, 4, 16
M = (S // C) * R


def _rand(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).to(dtype)


def _codes(rng, *shape):
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))


def _scales(rng, *shape):
    return torch.from_numpy(rng.uniform(0.01, 0.02, shape).astype(np.float32))


def _starts():
    return torch.tensor([0, 1], dtype=torch.int32)


def _bca_inputs(rng):
    return (_rand(rng, B, H, S, DH), _rand(rng, B, HKV, S, DH),
            _rand(rng, B, HKV, S, DH), _rand(rng, B, HKV, M, DH),
            _rand(rng, B, HKV, M, DH))


def _bwd_inputs(rng):
    q, k, v, kb, vb = _bca_inputs(rng)
    _, m, d = bca.blockwise_causal_attn_plain(
        q, k, v, kb, vb, block_size=C, block_slots=R, scale=0.25,
        return_residuals=True)
    return q, k, v, kb, vb, m, d, _rand(rng, B, H, S, DH)


def _prefix_inputs(rng):
    q, k, v, _, _ = _bca_inputs(rng)
    MP = M + 2 * R
    return (q, k, v, _rand(rng, B, HKV, MP, DH), _rand(rng, B, HKV, MP, DH),
            _starts())


def _prefix_q_inputs(rng):
    q, k, v, _, _ = _bca_inputs(rng)
    MP = M + 2 * R
    return (q, k, v, _codes(rng, B, HKV, MP, DH), _codes(rng, B, HKV, MP, DH),
            _scales(rng, B, HKV, MP), _scales(rng, B, HKV, MP), _starts())


DEC_G, DEC_M = 2, 12


def _biases(rng):
    return (torch.zeros(B, C), torch.zeros(B, DEC_M))


def _decode_inputs(rng):
    return (_rand(rng, B, HKV, DEC_G, DH), _rand(rng, B, HKV, C, DH),
            _rand(rng, B, HKV, C, DH), _rand(rng, B, HKV, DEC_M, DH),
            _rand(rng, B, HKV, DEC_M, DH), *_biases(rng))


def _decode_q_inputs(rng):
    return (_rand(rng, B, HKV, DEC_G, DH), _codes(rng, B, HKV, C, DH),
            _codes(rng, B, HKV, C, DH), _codes(rng, B, HKV, DEC_M, DH),
            _codes(rng, B, HKV, DEC_M, DH), _scales(rng, B, HKV, C),
            _scales(rng, B, HKV, C), _scales(rng, B, HKV, DEC_M),
            _scales(rng, B, HKV, DEC_M), *_biases(rng))


K_EXACT = 8


def _exact_inputs(rng):
    return (_rand(rng, B, H, S, DH), _rand(rng, B, HKV, K_EXACT, DH),
            _rand(rng, B, HKV, K_EXACT, DH))


def _sp_inputs(rng):
    return _rand(rng, B, H, S, DH), _rand(rng, S, K_EXACT)


BCA_KW = dict(block_size=C, block_slots=R, scale=0.25)
FWD_COST = bca.blockwise_causal_attn_cost(B, H, HKV, S, DH, block_size=C,
                                          block_slots=R, dtype_bytes=4)
# (case, wrapper, plain twin, inputs, kwargs, (counter owner, counter),
#  cost name, cost)
KERNELS = [
    ("1", bca.blockwise_causal_attn, bca.blockwise_causal_attn_plain,
     _bca_inputs, BCA_KW, (bca.blockwise_causal_attn, "launches"),
     "blockwise_causal_attn", FWD_COST),
    ("1r", bca.blockwise_causal_attn, bca.blockwise_causal_attn_plain,
     _bca_inputs, dict(BCA_KW, return_residuals=True),
     (bca.blockwise_causal_attn, "residual_launches"),
     "blockwise_causal_attn(return_residuals)",
     bca.blockwise_causal_attn_cost(B, H, HKV, S, DH, block_size=C,
                                    block_slots=R, dtype_bytes=4,
                                    return_residuals=True)),
    ("2", bca.blockwise_causal_attn_bwd, bca.blockwise_causal_attn_bwd_plain,
     _bwd_inputs, BCA_KW, (bca.blockwise_causal_attn_bwd, "launches"),
     "blockwise_causal_attn_bwd",
     bca.blockwise_causal_attn_bwd_cost(B, H, HKV, S, DH, M, block_size=C,
                                        block_slots=R, dtype_bytes=4)),
    ("2 offset", bca.blockwise_causal_attn_bwd,
     bca.blockwise_causal_attn_bwd_plain,
     lambda rng: _bwd_inputs(rng),
     dict(BCA_KW, start_blocks=torch.zeros(B, dtype=torch.int32)),
     (bca.blockwise_causal_attn_bwd, "offset_launches"),
     "blockwise_causal_attn_bwd(start_blocks)",
     bca.blockwise_causal_attn_bwd_cost(B, H, HKV, S, DH, M, block_size=C,
                                        block_slots=R, start_blocks=None,
                                        offset=True, dtype_bytes=4)),
    ("3", la.decode_attn, la.decode_attn_plain, _decode_inputs,
     dict(scale=0.25), (la.decode_attn, "launches"), "decode_attn",
     la.decode_attn_cost(B, HKV, DEC_G, DH, C, DEC_M, dtype_bytes=4)),
    ("4", bca.blockwise_causal_prefix_attn,
     lambda *a, **kw: bca.blockwise_causal_attn_plain(
         *a[:5], start_blocks=a[5], **kw),
     _prefix_inputs, BCA_KW, (bca.blockwise_causal_prefix_attn, "launches"),
     "blockwise_causal_prefix_attn",
     bca.blockwise_causal_prefix_attn_cost(
         B, H, HKV, S, DH, M + 2 * R, block_size=C, block_slots=R,
         start_blocks=None, dtype_bytes=4)),
    ("4r", bca.blockwise_causal_prefix_attn,
     lambda *a, **kw: bca.blockwise_causal_attn_plain(
         *a[:5], start_blocks=a[5], **kw),
     _prefix_inputs, dict(BCA_KW, return_residuals=True),
     (bca.blockwise_causal_prefix_attn, "residual_launches"),
     "blockwise_causal_prefix_attn(return_residuals)",
     bca.blockwise_causal_prefix_attn_cost(
         B, H, HKV, S, DH, M + 2 * R, block_size=C, block_slots=R,
         start_blocks=None, dtype_bytes=4, return_residuals=True)),
    ("5", la.linformer_attn, la.linformer_attn_plain, _exact_inputs,
     dict(scale=0.25), (la.linformer_attn, "launches"), "linformer_attn",
     la.linformer_attn_cost(B, H, HKV, S, K_EXACT, DH, dtype_bytes=4)),
    ("6", sp.seq_projection, sp.seq_projection_plain, _sp_inputs, {},
     (sp.seq_projection, "launches"), "seq_projection",
     sp.seq_projection_cost(B, H, S, K_EXACT, DH, dtype_bytes=4)),
    ("7", la.decode_attn_q, la.decode_attn_q_plain, _decode_q_inputs,
     dict(scale=0.25), (la.decode_attn_q, "launches"), "decode_attn_q",
     la.decode_attn_cost(B, HKV, DEC_G, DH, C, DEC_M, dtype_bytes=4,
                         cache_row_bytes=DH + 4)),
    ("8", bca.blockwise_causal_prefix_attn_q,
     bca.blockwise_causal_prefix_attn_q_plain, _prefix_q_inputs, BCA_KW,
     (bca.blockwise_causal_prefix_attn_q, "launches"),
     "blockwise_causal_prefix_attn_q",
     bca.blockwise_causal_prefix_attn_cost(
         B, H, HKV, S, DH, M + 2 * R, block_size=C, block_slots=R,
         start_blocks=None, dtype_bytes=4, slot_bytes=DH + 4)),
]


def _outs(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


@pytest.mark.parametrize("case", KERNELS, ids=[k[0] for k in KERNELS])
def test_fake_path_gives_the_plain_twins_shapes(case):
    _, wrapper, plain, make, kw, (owner, counter), name, cost = case
    xs = make(np.random.default_rng(0))
    want = _outs(plain(*xs, **kw))
    mode = FakeTensorMode()
    fakes = [mode.from_tensor(x) for x in xs]
    fkw = {k: mode.from_tensor(v) if isinstance(v, torch.Tensor) else v
           for k, v in kw.items()}
    seen = []
    before = getattr(owner, counter)
    with common.cost_sink(lambda *a: seen.append(a)), mode:
        got = _outs(wrapper(*fakes, **fkw))
    assert getattr(owner, counter) == before
    assert [(g.shape, g.dtype) for g in got] == \
        [(w.shape, w.dtype) for w in want]
    assert all(common.is_fake(g) for g in got)
    assert seen == [(name, *cost)]


@pytest.mark.parametrize("case", KERNELS, ids=[k[0] for k in KERNELS])
def test_real_cpu_tensor_reaches_the_plain_twin(case):
    _, wrapper, plain, make, kw, (owner, counter), _, _ = case
    xs = make(np.random.default_rng(1))
    before = getattr(owner, counter)
    seen = []
    with common.cost_sink(lambda *a: seen.append(a)):
        got = _outs(wrapper(*xs, **kw))
    want = _outs(plain(*xs, **kw))
    assert getattr(owner, counter) == before
    assert seen == []
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_costs_count_visible_work():
    """Known start blocks count the slots their rows see, fewer than the
    unknown-start bound; positions count each row's visible keys."""
    kw = dict(block_size=C, block_slots=R, dtype_bytes=2)
    seen = bca.blockwise_causal_prefix_attn_cost(B, H, HKV, S, DH, M + 2 * R,
                                                 start_blocks=[0, 1], **kw)
    bound = bca.blockwise_causal_prefix_attn_cost(B, H, HKV, S, DH,
                                                  M + 2 * R,
                                                  start_blocks=None, **kw)
    assert seen[0] < bound[0] and seen[1] < bound[1]
    f, nbytes = la.decode_attn_cost(1, HKV, DEC_G, DH, C, DEC_M,
                                    block_slots=R, positions=[C + 3])
    vis = (C + 3) % C + 1 + R
    assert f == 4 * DH * DEC_G * HKV * vis
    assert nbytes == 2 * 2 * HKV * DEC_G * DH + 2 * vis * HKV * 2 * DH \
        + 4 * (C + DEC_M)


def test_cli_writes_records_and_counts_failures(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    assert dryrun.main(["--arch", "internvl2-2b", "--shape",
                        "decode_32k"]) == 0
    (rec_path,) = tmp_path.iterdir()
    rec = json.loads(rec_path.read_text())
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["dominant"] in rec["roofline"]
    assert rec["argument_bytes"] == sum(
        rec["argument_bytes_by_part"].values())
    # both 16-wide dims leave the 8-card node: InfiniBand rates
    assert rec["link_rates"] == {"data": mesh_lib.H100_IB_BYTES_PER_S,
                                 "model": mesh_lib.H100_IB_BYTES_PER_S}
    # a cell the port refuses is reported and counted, not raised
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "long_500k"]) == 1
    out = capsys.readouterr().out
    assert "[dryrun] FAIL qwen3-8b × long_500k × 16x16" in out
    assert "[dryrun] 1 cells failed" in out
    rec = dryrun.run_cell("linformer-paper", "decode_32k", multi_pod=False)
    assert "skipped" in rec


_NV, _IB = mesh_lib.H100_NVLINK_BYTES_PER_S, mesh_lib.H100_IB_BYTES_PER_S


@pytest.mark.parametrize("shape,names,want", [
    ((16, 16), ("data", "model"), {"data": _IB, "model": _IB}),
    ((2, 16, 16), ("pod", "data", "model"),
     {"pod": _IB, "data": _IB, "model": _IB}),
    ((32, 8), ("data", "model"), {"data": _IB, "model": _NV}),
    ((2, 4), ("data", "model"), {"data": _NV, "model": _NV}),
    ((3, 2), ("data", "model"), {"data": _IB, "model": _NV}),
], ids=["16x16", "2x16x16", "32x8", "2x4", "3x2"])
def test_link_rates_follow_the_node(shape, names, want):
    """A dim's collectives run at NVLink's rate only where its groups lie
    inside one 8-card node (row-major ranks), else at InfiniBand's."""
    assert mesh_lib.link_rates(shape, names) == want


def test_collective_term_rates_each_dim_by_its_link():
    """The roofline's collective term divides each dim's bytes by its own
    link's rate: on the 16 × 16 mesh both dims cross nodes, so every byte
    goes at InfiniBand's rate, not NVLink's."""
    rec = dryrun.run_cell("internvl2-2b", "prefill_32k", multi_pod=False)
    by_dim = rec["collectives_by_dim"]
    assert set(by_dim) == {"data", "model"}
    assert sum(c["bytes"] for c in by_dim.values()) \
        == rec["collective_bytes_per_device"]
    assert rec["roofline"]["collective_s"] == pytest.approx(
        rec["collective_bytes_per_device"] / _IB, rel=1e-12)


def test_fake_step_counts_the_real_step():
    """On the plain route (no kernel) a fake step and the real CPU step run
    the same aten ops: equal FLOPs, peak, traffic and bounds."""
    cfg = dataclasses.replace(_smoke(3), remat="full", dtype="bfloat16"
                              ).with_attention_backend("reference")
    ocfg = OptimizerConfig()
    fake = dryrun.dry_run(cfg, TRAIN, None, device="cpu", ocfg=ocfg)
    params = model_lib.init_params(cfg, seed=0, device="cpu")
    for p in flatten(params).values():
        p.requires_grad_(True)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN.global_batch, TRAIN.seq_len),
        dtype=np.int32)) for k in ("tokens", "labels", "loss_mask")}
    real = measure(make_train_step(cfg, ocfg),
                   (params, adamw_init(params, ocfg), batch),
                   device_type="cpu")
    for k in ("aten_flops", "peak_bytes", "peak_storages", "bytes_upper",
              "bytes_lower"):
        assert fake[k] == real[k], k
    assert fake["kernel_flops"] == 0


class _JMesh:
    """A stand-in for a JAX mesh of data 2 × model 2 (names and widths
    are all JAX's spec rules read)."""
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 2}


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-1.6b"])
def test_ssm_decode_cell_takes_shards_and_jax_cache_specs(fake_ctx, arch):
    """A SMOKE decode cell of the ssm and hybrid families on data 2 ×
    model 2: every parameter is this rank's shard of JAX's spec (the
    training layout, as the transformer families' cells), and the
    recurrent cache leaves are this rank's share of JAX's cache specs
    (``mamba_ssm`` and ``wkv`` by heads over the model dim, ``mamba_conv``
    and the shifts whole, every leaf's rows over the data dim); the step
    counts its collectives."""
    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch import specs as jspecs
    from repro.parallel.sharding import ParallelCtx as JCtx
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    shape = ShapeConfig("decode_smoke", 64, 8, "decode")
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    _, _, parts = dryrun.build_step(cfg, shape, fake_ctx, mode=mode,
                                    device="cpu")
    params = flatten(parts["params"])
    for key, (whole, _, _) in model_lib.param_spec(cfg).items():
        want = _local(whole, spec_for_path(key, ("data",), len(whole)))
        assert list(params[key].shape) == want, key
    jcfg = jax_smoke(arch)
    wholes = jspecs.input_specs(jcfg, shape)["cache"]
    cspecs = jspecs.batch_specs(jcfg, shape, JCtx(mesh=_JMesh(),
                                                  fsdp="data"))["cache"]
    cache = parts["cache"]
    recurrent = ("mamba_ssm", "mamba_conv", "wkv", "tm_shift", "cm_shift")
    held = [k for k in recurrent if k in cache]
    assert held
    for key in held:
        assert list(cache[key].shape) == _local(wholes[key].shape,
                                                tuple(cspecs[key])), key
    for key in ("mamba_ssm", "wkv"):
        if key in cache:                 # SMOKE's heads divide the width
            assert tuple(cspecs[key])[2] == "model"
    rec = dryrun.dry_run(cfg, shape, fake_ctx, device="cpu")
    assert rec["argument_bytes_by_part"]["params"] == sum(
        v.numel() * v.element_size() for v in params.values())
    assert rec["collectives_by_dim"]["model"]["bytes"] > 0

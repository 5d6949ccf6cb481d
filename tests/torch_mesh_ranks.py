"""Rank side of the port's mesh tests: gloo process groups over CPU ranks.

`start_ranks` spawns one group of `world` ranks (one process each,
``torch.multiprocessing.spawn``) for all the cases of one test module. The
group opens through a file in the test's tmp dir (``file://``: no port to
collide on between xdist workers) with an explicit timeout, so a
collective that a rank never joins fails the spawn instead of hanging it.
Each rank runs one intra-op thread, imports no JAX, runs the case function
named by the module on the payload the parent wrote, and saves its results
(numpy arrays and Python scalars) for the parent, which holds them to the
JAX package. A rank's exception fails the spawn, and with it the module
fixture.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

MESHES = {"data2xtp2": (2, 1), "data2xsp2": (1, 2), "sp2xtp2": (2, 2)}


def start_ranks(tmp_dir, cases: str, payload: dict, world: int = 4):
    """Spawn `world` gloo ranks running the function `cases` of this module
    on `payload`, without waiting: the parent computes its oracle
    meanwhile. Returns `finish()`, which waits for the ranks (raising if
    one failed) and returns each rank's result dict, rank order."""
    import torch.multiprocessing as mp
    tmp_dir = str(tmp_dir)
    torch.save(payload, os.path.join(tmp_dir, "payload.pt"))
    procs = mp.spawn(_entry, args=(world, tmp_dir, cases), nprocs=world,
                     join=False)

    def finish():
        while not procs.join():
            pass
        return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]

    return finish


def _entry(rank, world, tmp_dir, cases):
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks
    torch.set_num_threads(1)
    init_ranks("gloo", "file://" + os.path.join(tmp_dir, "rendezvous"),
               rank, world)
    try:
        payload = torch.load(os.path.join(tmp_dir, "payload.pt"),
                             weights_only=False)
        out = globals()[cases](rank, payload)
        torch.save(out, os.path.join(tmp_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy().copy()


def _layer_cache(lc):
    out = {}
    for k, v in lc.items():
        if isinstance(v, tuple):          # fp8 codes as (uint8 bits, tag)
            out[k] = torch.from_numpy(v[0].copy()).view(torch.float8_e4m3fn)
        else:
            out[k] = _t(v)
    return out


def _leaves_np(lc):
    return {k: (v.view(torch.uint8).numpy().copy()
                if v.dtype == torch.float8_e4m3fn else _np(v))
            for k, v in lc.items()}


def _loss_and_grads(cfg, params_flat, batch, ctx):
    from repro_torch.checkpoint import bridge
    from repro_torch.models import model as tmodel
    from repro_torch.models import transformer as ttransformer
    params = bridge.params_from_flat(params_flat, cfg, device="cpu")
    flat = ttransformer.flatten(params)
    for p in flat.values():
        p.requires_grad_(True)
    loss, _ = tmodel.loss_fn(params, cfg, batch, ctx=ctx)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return {"loss": float(loss),
            "grads": {k: _np(g) for k, g in zip(flat, grads)}}


# ---------------------------------------------------------------------------
# tests/test_torch_plan_parallel.py
# ---------------------------------------------------------------------------


def plan_cases(rank, p):
    from repro_torch.configs import config_from_dict
    from repro_torch.core import cache as tcache
    from repro_torch.core import seq_parallel as tsp
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import comm
    from repro_torch.parallel.plan import resolve_attention_plan
    from repro_torch.parallel.sharding import ParallelCtx

    meshes = {name: make_local_mesh(ms, ss, device_type="cpu")
              for name, (ms, ss) in MESHES.items()}
    out = {"rank": rank}
    batch = {k: _t(v) for k, v in p["batch"].items()}

    # model-level loss and every gradient leaf, remat "full"
    for hkv in (4, 2):
        cfg = config_from_dict(p[f"cfg{hkv}"])
        for name, mesh in meshes.items():
            ctx = ParallelCtx(mesh=mesh, fsdp="data")
            plan = resolve_attention_plan(cfg.attention, ctx)
            if not plan.manual:
                raise AssertionError(f"{name}: plan not manual")
            out[("train", hkv, name)] = _loss_and_grads(
                cfg, p[f"params{hkv}"], batch, ctx)

    # cache-level chunk prefill and decode: dense, int8 and fp8 pools
    ccfg = config_from_dict(p["cfg2"])
    c = p["cache"]
    q, k, v, E, F = (_t(c[n]) for n in ("q", "k", "v", "E", "F"))
    t0, td = _t(c["t0"]), _t(c["td"])
    qd, kd, vd = q[:, :1], k[:, :1], v[:, :1]
    for name, mesh in meshes.items():
        plan = resolve_attention_plan(ccfg.attention, ParallelCtx(mesh=mesh))
        for fmt in ("dense", "int8", "fp8"):
            prefill, decode = (
                (tcache.compressed_prefill_chunk,
                 tcache.compressed_decode_attention) if fmt == "dense" else
                (tcache.paged_prefill_chunk, tcache.paged_decode_attention))
            # each pool laid out per the plan's cache_pspecs, and gathered
            # whole again for the comparison
            o, lc = prefill(q, k, v, plan.place_cache(
                _layer_cache(c[f"lc_{fmt}"])), E, F, t0, plan=plan)
            do, dlc = decode(qd, kd, vd, plan.place_cache(
                _layer_cache(c[f"lc_{fmt}"])), E, F, td, plan=plan)
            lc, dlc = plan.gather_cache(lc), plan.gather_cache(dlc)
            out[("cache", fmt, name)] = {
                "prefill": _np(o), "prefill_cache": _leaves_np(lc),
                "decode": _np(do), "decode_cache": _leaves_np(dlc)}

    # the exact form (layerwise-shared linear E, MLM) on sp2 x tp2
    ecfg = config_from_dict(p["ecfg"])
    ectx = ParallelCtx(mesh=meshes["sp2xtp2"])
    if not resolve_attention_plan(ecfg.attention, ectx).manual:
        raise AssertionError("exact form: plan not manual")
    out["exact"] = _loss_and_grads(ecfg, p["eparams"], batch, ectx)

    # seq_parallel_linformer_attention over 4 shards of the model dim
    s = p["sp4"]
    ctx4 = ParallelCtx(mesh=make_local_mesh(4, device_type="cpu"))
    out["sp4"] = _np(tsp.seq_parallel_linformer_attention(
        *(_t(s[n]) for n in ("q", "k", "v", "E", "F")), ctx4))

    # the sp refusal: S = 24 at c = 8 over sp = 2
    plan = resolve_attention_plan(ccfg.attention,
                                  ParallelCtx(mesh=meshes["data2xsp2"]))
    x = torch.zeros(2, 24, 4, 8)
    try:
        plan.causal_attention(x, x[:, :, :2], x[:, :, :2], E, F,
                              block_size=8, block_slots=2, scale=0.5)
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)

    # comm bytes of one layer: sp's all-gather (causal), the exact psum
    b = p["bytes"]
    with torch.no_grad():
        comm.reset_counters()
        plan.causal_attention(*(_t(b[n]) for n in ("q", "k", "v", "E", "F")),
                              block_size=8, block_slots=2, scale=0.5)
        out["bytes_causal"] = dict(comm.BYTES)
        comm.reset_counters()
        eplan = resolve_attention_plan(ecfg.attention, ectx)
        eq = [_t(b[n])[:1] for n in ("q", "k", "v")]
        eplan.exact_attention(*eq, _t(b["Ex"]), _t(b["Ex"]),
                              projection="linear", scale=0.5)
        out["bytes_exact"] = dict(comm.BYTES)
        # a "reference" plan under the mesh opens no region
        comm.reset_counters()
        rcfg = dataclasses.replace(ccfg.attention, backend="reference")
        rplan = resolve_attention_plan(rcfg, ectx)
        ref = rplan.causal_attention(
            *(_t(b[n]) for n in ("q", "k", "v", "E", "F")), block_size=8,
            block_slots=2, scale=0.5)
        out["reference"] = {"manual": rplan.manual, "bytes": dict(comm.BYTES),
                            "out": _np(ref)}
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_moe_parallel.py
# ---------------------------------------------------------------------------


def _moe_run(params_np, x_np, g_np, cfg, mlp, ctx, aux_weight):
    from repro_torch.models import moe as tmoe
    params = {k: _t(v).requires_grad_(True) for k, v in params_np.items()}
    x = _t(x_np).requires_grad_(True)
    out, aux = tmoe.apply_moe(params, x, cfg, mlp, ctx)
    total = (out * _t(g_np)).sum() + aux_weight * aux
    leaves = [x] + list(params.values())
    grads = torch.autograd.grad(total, leaves)
    return {"out": _np(out), "aux": float(aux),
            "grads": dict(zip(["x"] + list(params), map(_np, grads)))}


def moe_cases(rank, p):
    from repro_torch.configs.base import MLPConfig, MoEConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel.sharding import ParallelCtx

    mlp = MLPConfig(activation="swiglu")
    meshes = {"data2xtp2": make_local_mesh(2, device_type="cpu"),
              "tp4": make_local_mesh(4, device_type="cpu")}
    out = {"rank": rank}
    for cf in p["capacity_factors"]:
        cfg = MoEConfig(**{**p["moe"], "capacity_factor": cf})
        for name, mesh in meshes.items():
            out[("ep", cf, name)] = _moe_run(
                p["params"], p["x"], p["g"], cfg, mlp, ParallelCtx(mesh=mesh),
                p["aux_weight"])
        ws = dataclasses.replace(cfg, weight_stationary_decode=True)
        out[("ws", cf)] = _moe_run(
            p["params"], p["x_dec"], p["g_dec"], ws, mlp,
            ParallelCtx(mesh=meshes["data2xtp2"], fsdp="data"),
            p["aux_weight"])
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_serve_mesh.py
# ---------------------------------------------------------------------------


def _stats(st):
    from repro_torch.serving.scheduler import _STAT_COUNTERS
    return {**{k: getattr(st, k) for k in _STAT_COUNTERS}, "ticks": st.ticks}


def _rows_np(rows):
    """A snapshot's leaves as raw bytes (uint8 views) and dtypes."""
    from repro_torch.serving.snapshot import leaf_bytes
    return {k: (leaf_bytes(v).numpy().copy(), str(v.dtype), tuple(v.shape))
            for k, v in rows.items()}


def _admit_snapshot(eng, prompt, jax_rows):
    """Admit `prompt` into row 0 of a 2-row SlotPool and snapshot it; then
    restore JAX's snapshot of the same admission (`jax_rows`, host arrays)
    into row 1, a paged one into fresh pages, and snapshot row 1 back."""
    from repro_torch.serving import Request, SlotPool
    from repro_torch.serving.snapshot import capture
    sp = SlotPool(eng, 2)
    local = {k: tuple(v.shape) for k, v in sp.cache.items()}
    cache, logits = eng.prefill(np.asarray([prompt], np.int64))
    req = Request(rid=0, tokens=tuple(prompt), max_new_tokens=4)
    first = int(torch.argmax(logits[0]))
    sp.admit(0, req, cache, first)
    snap = sp.snapshot_rows([0], tick=0)[0]
    jsnap = capture(rid=0, state=snap.state, filled=snap.filled, cur=first,
                    finished=False, emitted=[], tick=0,
                    cache_rows={k: _t(v) for k, v in jax_rows.items()})
    sp.restore(1, req, jsnap)
    back = sp.snapshot_rows([1], tick=0)[0]
    return {"snap": {k: _np(v) for k, v in snap.cache_rows.items()},
            "verify": snap.verify(), "jax_crc": jsnap.checksum,
            "back_crc": back.checksum, "back": _rows_np(back.cache_rows),
            "local": local}


def serve_cases(rank, p):
    from repro_torch.checkpoint import bridge
    from repro_torch.configs import config_from_dict
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel.sharding import ParallelCtx
    from repro_torch.serving import Fault, FaultInjector, ServingEngine

    cfg = config_from_dict(p["cfg"])
    params = bridge.params_from_flat(p["params"], cfg, device="cpu")
    ctx = ParallelCtx(mesh=make_local_mesh(2, device_type="cpu"))
    out = {"rank": rank}

    def mk(ctx, **kw):
        return ServingEngine(params, cfg, max_seq=64, device="cpu",
                             cache_dtype=torch.float32, decode_chunk=4,
                             ctx=ctx, **kw)

    # 1. chunked admission
    eng = mk(ctx, prefill_chunk=16)
    out["tp"] = eng.plan.tp
    out["pool"] = {k: tuple(v.shape)
                   for k, v in eng.init_pool_cache(2).items()}
    out["chunked"] = eng.serve(p["prompts4"], 6, max_batch=2)
    # 2. preemption, a faulted row's quarantine and retry
    o, s = eng.serve(p["prompts6"], p["budgets"], **p["kw"])
    out["preempt"] = (o, _stats(s.stats))
    inj = FaultInjector([Fault("slot_step", chunk=1, row=0)])
    o, s = eng.serve(p["prompts6"], p["budgets"], max_batch=2,
                     snapshot_chunks=1, fault_injector=inj,
                     return_scheduler=True)
    out["fault"] = (o, _stats(s.stats))
    out["dense_snap"] = _admit_snapshot(mk(ctx), p["prompts6"][0],
                                        p["jax_rows"]["dense"])
    # 3. the paged pool: preemption through quantized snapshots, and a
    # snapshot restored into fresh pages
    peng = mk(ctx, prefill_chunk=16, cache_format="paged")
    out["paged_pool"] = {k: tuple(v.shape)
                         for k, v in peng.init_pool_cache(2).items()}
    o, s = peng.serve(p["prompts6"], p["budgets"], snapshot_chunks=2,
                      **p["kw"])
    out["paged"] = (o, _stats(s.stats))
    out["paged_snap"] = _admit_snapshot(mk(ctx, cache_format="paged"),
                                        p["prompts6"][0],
                                        p["jax_rows"]["paged"])
    # 4. the hybrid family: its attention entries laid out per
    # cache_pspecs, served against the same engine with no mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as tmodel
    hcfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"),
                               dtype="float32")
    hparams = tmodel.init_params(hcfg, seed=0, device="cpu")

    def hybrid(c):
        eng = ServingEngine(hparams, hcfg, max_seq=64, device="cpu",
                            cache_dtype=torch.float32, decode_chunk=4,
                            ctx=c)
        return eng, eng.serve(p["prompts4"], 6, max_batch=2)

    heng, out["hybrid"] = hybrid(ctx)
    out["hybrid_tp"] = heng.plan.tp
    out["hybrid_whole_hkv"] = hcfg.attention.num_kv_heads
    out["hybrid_attn"] = {k: tuple(v.shape) for k, v in tmodel.init_cache(
        hcfg, batch=2, max_seq=64, device="cpu",
        plan=heng.plan)["attn"].items()}
    out["hybrid_one"] = hybrid(None)[1]
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_train_mesh.py
# ---------------------------------------------------------------------------


def _whole_np(tree, ctx, cfg=None):
    """Every leaf of a tree of shards, whole, as numpy (each rank); `cfg`
    gives the whole shapes where the vocabulary splits unevenly."""
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import flatten
    from repro_torch.parallel import sharding as shd
    shapes = {} if cfg is None else {
        k: shape for k, (shape, *_) in tmodel.param_spec(cfg).items()}
    out = {}
    with torch.no_grad():
        for k, v in flatten(tree).items():
            out[k] = _np(shd.unshard_leaf(v, shd.leaf_spec(k, v.ndim, ctx),
                                          ctx, shape=shapes.get(k)))
    return out


class _VocabWatch(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the shape of every op output whose last dim is the whole
    vocabulary `V` with at least `rows` rows before it: a whole LM head
    (d_model rows), or the logits of `rows` tokens or more (a row of the
    batch)."""

    def __init__(self, V, rows):
        super().__init__()
        self.V, self.rows, self.seen = V, rows, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.ndim and \
                    t.shape[-1] == self.V and t.numel() >= self.rows * self.V:
                self.seen.append((str(func), tuple(t.shape)))
        return out


def _mesh_steps(cfg, flat, ctx, batches, ocfg, microbatch=0):
    """make_train_step(ctx=) over `batches` from JAX's weights `flat`: the
    losses, the first step's collective bytes by op (`comm.BYTES`) and by
    (op, mesh dim), the outputs of that step's ops with the whole
    vocabulary as their last dim, every parameter and first moment whole
    afterwards, and each rank's shapes of its parameter and first-moment
    shards."""
    from repro_torch.checkpoint import bridge
    from repro_torch.models.transformer import flatten
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import comm
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.trainer import make_train_step, training_ctx
    tctx = training_ctx(ctx)
    params = shd.shard_tree(bridge.params_from_flat(flat, cfg, device="cpu"),
                            tctx)
    for p in flatten(params).values():
        p.requires_grad_(True)
    opt = adamw_init(params, ocfg)
    step = make_train_step(cfg, ocfg, microbatch=microbatch, ctx=ctx)
    losses, first, op_dim, watch = [], None, None, None
    for b in batches:
        comm.reset_counters()
        if watch is None:
            with _VocabWatch(cfg.padded_vocab_size,
                             b["labels"].shape[1]) as watch:
                params, opt, m = step(params, opt,
                                      {k: _t(v) for k, v in b.items()})
        else:
            params, opt, m = step(params, opt,
                                  {k: _t(v) for k, v in b.items()})
        first = dict(comm.BYTES) if first is None else first
        op_dim = dict(comm.OP_DIM_BYTES) if op_dim is None else op_dim
        losses.append(float(m["loss"]))
    return {"losses": losses, "bytes": first, "op_dim_bytes": op_dim,
            "vocab_outputs": watch.seen,
            "params": _whole_np(params, tctx, cfg),
            "mu": _whole_np(opt["mu"], tctx, cfg),
            "local": {k: tuple(v.shape) for k, v in flatten(params).items()},
            "mu_local": {k: tuple(v.shape)
                         for k, v in flatten(opt["mu"]).items()}}


def _whole_cache(cfg, cache, tctx):
    """An ssm or hybrid cache laid out under the training layout, whole
    (every rank): the Mamba2/RWKV6 states gathered over the model dim by
    heads where they are sharded, the attention entries per the plan's
    cache_pspecs, every leaf's rows (dim 1) over the data dims; as numpy,
    flat, keyed as JAX's."""
    from repro_torch.models import rwkv_model, zamba
    from repro_torch.models import transformer as ttransformer
    from repro_torch.parallel import comm
    from repro_torch.parallel import plan as plan_lib
    from repro_torch.parallel import sharding as shd
    data = [tctx.axis(a) for a in tctx.data_axes]
    impl = zamba if cfg.family == "hybrid" else rwkv_model
    tp = impl.ssm_axis(cfg, tctx)[0]
    cache = dict(cache)
    if "attn" in cache:
        plan = ttransformer.tp_plan(cfg, plan_lib.resolve_attention_plan(
            cfg.attention, shd.region_ctx(tctx)), tctx)
        cache["attn"] = plan.gather_cache(cache["attn"])
    out = {}
    for k, v in ttransformer.flatten(cache).items():
        if k in ("mamba_ssm", "wkv"):
            v = comm.gather(v, 2, (tp,))
        out[k] = _np(v if k == "length" else comm.gather(v, 1, data))
    return out


def _mesh_infer(cfg, flat, ctx, inputs, max_seq):
    """The prefill step (``forward(..., return_cache=True)``; the exact
    form: ``forward`` alone), for a transformer-family causal config
    ``prefill_chunk`` of `inputs`' chunk, and ``decode_step`` over the
    columns of its feed, under the training layout from JAX's weights
    `flat`: each step's logits gathered whole over the model dim and the
    data dims, an ssm or hybrid config's prefill cache whole, the outputs
    of the prefill's ops with the whole vocabulary as their last dim, and
    the collective bytes by (op, mesh dim) of the prefill and of the
    decode steps."""
    from repro_torch.checkpoint import bridge
    from repro_torch.models import model as tmodel
    from repro_torch.models import transformer as ttransformer
    from repro_torch.parallel import comm
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.plan import local_batch
    from repro_torch.train.trainer import training_ctx
    tctx = training_ctx(ctx)
    params = shd.shard_tree(bridge.params_from_flat(flat, cfg, device="cpu"),
                            tctx)
    data = [tctx.axis(a) for a in tctx.data_axes]
    causal = cfg.attention.kind != "linformer"
    chunked = cfg.family in ttransformer.TRANSFORMER_FAMILIES

    def rows(x):
        return _np(comm.gather(x, 0, data))

    local = local_batch({k: _t(v) for k, v in inputs.items()}, tctx)
    out = {"decode": []}
    with torch.no_grad():
        comm.reset_counters()
        with _VocabWatch(cfg.padded_vocab_size,
                         local["tokens"].shape[1]) as watch:
            logits, _, cache = tmodel.forward(
                params, cfg, {"tokens": local["tokens"]}, ctx=tctx,
                return_cache=causal, cache_max_seq=max_seq,
                cache_dtype=torch.float32)
        out["vocab_outputs"] = watch.seen
        out["op_dim_bytes"] = dict(comm.OP_DIM_BYTES)
        out["local_vocab"] = logits.shape[-1]
        out["prefill"] = rows(ttransformer.gather_logits(logits, cfg, tctx))
        if not causal:
            return out
        if chunked:
            lc, cache = tmodel.prefill_chunk(params, cfg, local["chunk"],
                                             cache, local["valid"], ctx=tctx)
            out["chunk"] = rows(lc)
        else:
            out["cache"] = _whole_cache(cfg, cache, tctx)
        comm.reset_counters()
        for i in range(local["feed"].shape[1]):
            lt, cache = tmodel.decode_step(
                params, cfg, local["feed"][:, i:i + 1], cache, ctx=tctx)
            out["decode"].append(lt)
        out["decode_op_dim_bytes"] = dict(comm.OP_DIM_BYTES)
        out["decode"] = [rows(lt) for lt in out["decode"]]
    return out


def _compressed_steps(cfg, flat, ctx, batches, ocfg):
    """The compressed cross-pod step from JAX's weights: its losses, and for
    each step the whole parameters and the residual in JAX's (n_pods, ...)
    layout that it starts from, and the reduced gradient it applies."""
    from repro_torch.checkpoint import bridge
    from repro_torch.models.transformer import flatten
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import comm
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import compressed_dp as cdp
    tctx = cdp.inner_ctx(ctx)
    params = shd.shard_tree(bridge.params_from_flat(flat, cfg, device="cpu"),
                            tctx)
    for p in flatten(params).values():
        p.requires_grad_(True)
    opt = adamw_init(params, ocfg)
    res = cdp.init_local_residual(params)
    reduced, reduce = [], cdp.reduce_across_pods

    def recording(g, r, c):
        red, new = reduce(g, r, c)
        reduced.append(_whole_np(red, tctx))
        return red, new

    cdp.reduce_across_pods = recording
    pod = ctx.axis("pod")
    try:
        step = cdp.make_compressed_train_step(cfg, ocfg, ctx)
        losses, states = [], []
        for b in batches:
            states.append((_whole_np(params, tctx), {
                k: _np(comm.all_gather_stack(_t(v), pod))
                for k, v in _whole_np(res, tctx).items()}))
            params, opt, res, m = step(params, opt, res,
                                       {k: _t(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
    finally:
        cdp.reduce_across_pods = reduce
    return {"losses": losses, "reduced": reduced, "states": states}


def _trainer_compressed(cfg, ctx, d):
    """JAX's end-to-end compressed Trainer case: 6 steps with checkpoints
    every 3 (the residual in JAX's (n_pods, ...) layout), then a resume
    to step 8."""
    import torch.distributed as dist
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.train import Trainer
    tcfg = TrainConfig(seq_len=32, global_batch=8, steps=6, log_every=99,
                       checkpoint_every=3, checkpoint_dir=d,
                       compressed_pod_grads=True,
                       optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                 total_steps=20))
    tr = Trainer(cfg, tcfg, device="cpu", ctx=ctx, log_fn=lambda s: None)
    m = tr.run()
    residual = _whole_np(tr._residual, tr.ctx)
    tr2 = Trainer(cfg, dataclasses.replace(tcfg, steps=8), device="cpu",
                  ctx=ctx, log_fn=lambda s: None)
    _, _, _, start = tr2.restore_or_init()
    restored = _whole_np(tr2._residual, tr2.ctx)
    m2 = tr2.run()
    dist.barrier()
    with np.load(os.path.join(d, "step_00000006", "residual.npz")) as z:
        saved = {k: z[k] for k in z.files}
    pod = tr.ctx.axis("pod").coord
    same = all(np.array_equal(saved[k][pod], restored[k]) and
               np.array_equal(restored[k], residual[k]) for k in residual)
    return {"compressed": tr.compressed, "start": start,
            "loss": m["loss"], "loss2": m2["loss"], "residual_same": same,
            "saved_shapes": {k: v.shape for k, v in saved.items()}}


def _elastic(cfg, ctx, d):
    """Resume a single-device checkpoint (JAX's, at step 2) on this mesh,
    train to step 4 and save; rank 0 alone then resumes that checkpoint
    with no mesh and trains to step 6 (elastic restart and back)."""
    import time
    import torch.distributed as dist
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.models.transformer import flatten
    from repro_torch.train import Trainer
    deadline = time.time() + 300
    while not os.path.exists(os.path.join(d, "ready")):
        if time.time() > deadline:
            raise TimeoutError("no single-device checkpoint")
        time.sleep(0.2)
    tcfg = TrainConfig(seq_len=32, global_batch=8, steps=4, log_every=99,
                       checkpoint_every=2, checkpoint_dir=d,
                       optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                 total_steps=20))
    tr = Trainer(cfg, tcfg, device="cpu", ctx=ctx, log_fn=lambda s: None)
    params, opt, _, start = tr.restore_or_init()
    out = {"start": start,
           "local": {k: tuple(v.shape) for k, v in flatten(params).items()},
           "mu_local": {k: tuple(v.shape)
                        for k, v in flatten(opt["mu"]).items()}}
    tr.run()
    if dist.get_rank() == 0:
        back = Trainer(cfg, dataclasses.replace(tcfg, steps=6),
                       device="cpu", log_fn=lambda s: None)
        out["back_start"] = back.restore_or_init()[3]
        back.run()
    dist.barrier()
    return out


def train_cases(rank, p):
    import time
    from repro_torch.configs import config_from_dict
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.launch.mesh import make_local_mesh, make_mesh
    from repro_torch.parallel.sharding import ParallelCtx
    ocfg = OptimizerConfig(**p["ocfg"])
    d2t2 = make_local_mesh(2, device_type="cpu")
    out = {"rank": rank, "walls": {}}
    t0 = time.perf_counter()
    for name, case in p["cases"].items():
        out["walls"][name] = time.perf_counter() - t0
        cfg = config_from_dict(case["cfg"])
        if case.get("names"):
            mesh = make_mesh(case["mesh"], case["names"], device_type="cpu")
        elif case["mesh"] != (2,):
            mesh = make_local_mesh(*case["mesh"], device_type="cpu")
        else:
            mesh = d2t2
        ctx = ParallelCtx(mesh=mesh, fsdp=case["fsdp"])
        out[name] = _mesh_steps(cfg, p["params"][case["params"]], ctx,
                                p["batches"][case["batches"]],
                                OptimizerConfig(**p["ocfg"],
                                                **case.get("opt", {})),
                                case.get("microbatch", 0))
        if case.get("infer"):
            out[name]["infer"] = _mesh_infer(
                cfg, p["params"][case["params"]], ctx,
                p["infer"][case["batches"]], p["max_seq"])
    pod = make_mesh((2, 2, 1), ("pod", "data", "model"), device_type="cpu")
    dense = config_from_dict(p["cases"]["dense"]["cfg"])
    out["compressed"] = _compressed_steps(
        dense, p["params"]["dense"], ParallelCtx(mesh=pod, fsdp="data"),
        p["batches"]["causal"], ocfg)
    out["trainer_compressed"] = _trainer_compressed(
        dense, ParallelCtx(mesh=pod, fsdp="none"), p["trainer_dir"])
    out["walls"]["compressed"] = time.perf_counter() - t0
    out["elastic"] = _elastic(dense, ParallelCtx(mesh=d2t2, fsdp="data"),
                              p["elastic_dir"])
    out["walls"]["end"] = time.perf_counter() - t0
    return out

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
            o, lc = prefill(q, k, v, _layer_cache(c[f"lc_{fmt}"]), E, F, t0,
                            plan=plan)
            do, dlc = decode(qd, kd, vd, _layer_cache(c[f"lc_{fmt}"]), E, F,
                             td, plan=plan)
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

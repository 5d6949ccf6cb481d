"""Dry run of every (architecture × input shape) cell on the production
mesh, with no card and no memory: FakeTensors through the port's real step
functions, on a fake process group of 256 (or 512) ranks, this process
rank 0.

    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape decode_32k --multi-pod
    python -m repro_torch.launch.dryrun --all            # every cell, both meshes

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell for a TPU pod. Here the cell's parameters (and, training, the AdamW
moments) are FakeTensors of this rank's shard (``param_shardings``), the
inputs those of ``launch/specs.py``, and the step the port's own:

* train: ``make_train_step`` (forward, backward, clip, AdamW) under the
  training layout, the global batch given as the Trainer gives it;
* prefill: ``forward(..., return_cache=True)`` under the training layout
  (sharded parameters, this rank's rows), no grad;
* decode: ``decode_step`` under the training layout, as JAX's
  ``build_step`` takes ``param_shardings``: this rank's rows, its shards
  of the parameters and its heads of the cache (the KV heads, or the
  Mamba2 and RWKV6 states by JAX's cache specs); the step runs
  tensor-parallel and gathers the last token's logits whole.

``launch/step_cost.measure`` counts the step. Each cell's record (under
``build/dryrun/``) holds the argument bytes (parameters, moments, batch,
cache: exact), the peak of live storage, FLOPs a device (aten and
kernels), the bytes lower and upper bounds, the collectives by op and by
mesh dim, the three roofline terms at the H100's datasheet rates
(``launch/mesh.H100_*``: figures, not measurements; each dim's collective
bytes over the rate of the link it crosses, ``mesh.link_rates``: on
16-wide dims every collective leaves its 8-card node) and the dominant one,
``model_flops_per_chip`` (6 or 2 × active parameters × tokens ÷ chips),
the useful-FLOPs ratio and the dry run's wall time.

The fake tensors live on "cuda" where torch has a card and on "cpu"
otherwise (autograd will not take fake CUDA tensors in a CPU build); no
count depends on it: every kernel wrapper takes its fake path for a
FakeTensor whichever its device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import _ARCH_MODULES, get_config
from repro_torch.configs.base import (SHAPES_BY_NAME, ModelConfig,
                                      OptimizerConfig, ShapeConfig)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs
from repro_torch.launch.step_cost import measure, storage_bytes
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.models.transformer import nest
from repro_torch.optim import adamw_init
from repro_torch.parallel import plan as plan_lib
from repro_torch.parallel import sharding as shd
from repro_torch.train.trainer import make_train_step, training_ctx

ARCH_IDS = tuple(_ARCH_MODULES)
ARTIFACT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "..", "..", "build", "dryrun")
DEVICE_BYTES = 80e9          # one H100 80GB's memory


def fake_device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def fake_params(cfg: ModelConfig, ctx: Optional[shd.ParallelCtx], *, mode,
                device: str, requires_grad: bool) -> Dict:
    """FakeTensor parameters of `cfg` from ``model.param_spec``: this
    rank's shard of each leaf per ``param_shardings`` under `ctx` (whole
    without one)."""
    flat = {}
    for key, (shape, _, dtype) in model_lib.param_spec(cfg).items():
        if ctx is not None and ctx.mesh is not None:
            shape = tuple(s.stop - s.start
                          for s in shd.leaf_slices(key, shape, ctx))
        with mode:
            flat[key] = torch.empty(shape, dtype=dtype, device=device,
                                    requires_grad=requires_grad)
    return nest(flat)


def build_step(cfg: ModelConfig, shape: ShapeConfig,
               ctx: Optional[shd.ParallelCtx], *, mode, device: str,
               microbatch: int = 0, ocfg: Optional[OptimizerConfig] = None):
    """(step function, its FakeTensor arguments, {part: its tensors}) of
    one cell on `ctx` (None: one device, no mesh); a train step with
    `ocfg` (default OptimizerConfig())."""
    if shape.kind == "train":
        params = fake_params(cfg, ctx, mode=mode, device=device,
                             requires_grad=True)
        ocfg = ocfg or OptimizerConfig()
        with mode:
            opt = adamw_init(params, ocfg)
        # the step counter is a host tensor: a real one, which the fake
        # mode takes as a constant (AdamW reads it as host scalars)
        opt["step"] = torch.zeros((), dtype=torch.int32)
        batch = specs.input_specs(cfg, shape, mode=mode, device=device)
        step = make_train_step(cfg, ocfg, ctx=ctx, microbatch=microbatch)
        parts = {"params": params, "moments": (opt["mu"], opt["nu"]),
                 "batch": batch}
        return step, (params, opt, batch), parts

    if shape.kind == "prefill":
        tctx = training_ctx(ctx)
        params = fake_params(cfg, ctx, mode=mode, device=device,
                             requires_grad=False)
        batch = specs.batch_specs(cfg, shape, ctx, mode=mode, device=device)

        def prefill_step(params, batch):
            with torch.no_grad():
                logits, _, cache = model_lib.forward(
                    params, cfg, batch, ctx=tctx, return_cache=True,
                    cache_max_seq=shape.seq_len)
            return logits, cache

        return prefill_step, (params, batch), {"params": params,
                                               "batch": batch}

    # decode: this rank's rows, its shards of the parameters and its heads
    # of the cache: the KV heads of the plan the step holds to them, the
    # Mamba2 and RWKV6 states by JAX's cache specs (the training layout,
    # as JAX's decode cells take param_shardings)
    tctx = training_ctx(ctx)
    plan = transformer.tp_plan(cfg, plan_lib.resolve_attention_plan(
        cfg.attention, shd.region_ctx(tctx)), tctx)
    params = fake_params(cfg, ctx, mode=mode, device=device,
                         requires_grad=False)
    inputs = specs.batch_specs(cfg, shape, tctx, mode=mode, device=device,
                               plan=plan)

    def serve_step(params, batch_t, cache):
        with torch.no_grad():
            return model_lib.decode_step(
                params, cfg, batch_t.get("tokens"), cache,
                embeds=batch_t.get("embeds"), plan=plan, ctx=tctx)

    return serve_step, (params, inputs["batch_t"], inputs["cache"]), {
        "params": params, "batch": inputs["batch_t"],
        "cache": inputs["cache"]}


def model_flops_per_chip(cfg: ModelConfig, shape: ShapeConfig,
                         chips: int) -> float:
    """JAX's useful FLOPs a chip: 6 (train) or 2 × active parameters ×
    tokens (decode: one a row) ÷ chips."""
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    return mult * cfg.active_param_count_estimate * tokens / chips


def configure(arch: str, *, attention: Optional[str] = None,
              remat: Optional[str] = None,
              lin_overrides: Optional[Dict] = None,
              model_overrides: Optional[Dict] = None) -> ModelConfig:
    cfg = get_config(arch)
    if attention and cfg.family != "ssm":
        cfg = cfg.with_attention_kind(attention)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    if model_overrides:
        cfg = dataclasses.replace(cfg, **model_overrides)
    if lin_overrides:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, linformer=dataclasses.replace(
                cfg.attention.linformer, **lin_overrides)))
    return cfg


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """Why a cell does not run, or None. JAX's rule (full attention at
    524288), and the exact form's: E has max_seq_len rows and no decode
    cache exists (the JAX package serves neither)."""
    kind = cfg.attention.kind if cfg.family != "ssm" else "native"
    if shape.name == "long_500k" and kind == "standard":
        return "pure full attention at 500k (O(n^2) / 21-214GB KV per seq)"
    if kind == "linformer":
        if shape.kind == "decode":
            return "the exact (bidirectional) form has no decode cache"
        if shape.seq_len > cfg.max_seq_len:
            return (f"the exact form's E has max_seq_len = "
                    f"{cfg.max_seq_len} rows, the shape {shape.seq_len}")
    return None


def dry_run(cfg: ModelConfig, shape: ShapeConfig,
            ctx: Optional[shd.ParallelCtx], *, device: str,
            microbatch: int = 0, ocfg: Optional[OptimizerConfig] = None
            ) -> Dict:
    """Count one step of `cfg` at `shape` on `ctx` (None: one device) with
    FakeTensors on `device`: launch/step_cost.measure's counts, and the
    argument bytes by part."""
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    step, args, parts = build_step(cfg, shape, ctx, mode=mode,
                                   device=device, microbatch=microbatch,
                                   ocfg=ocfg)
    dev_type = torch.device(device).type
    with mode:
        rec = measure(step, args, device_type=dev_type)
    rec.pop("out")
    # the parts leave out the optimizer's step counter, a host tensor
    rec["argument_bytes_by_part"] = {k: storage_bytes(v, dev_type)
                                     for k, v in parts.items()}
    rec["argument_bytes"] = sum(rec["argument_bytes_by_part"].values())
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             attention: Optional[str] = None, remat: Optional[str] = None,
             fsdp: Optional[str] = None,
             lin_overrides: Optional[Dict] = None,
             model_overrides: Optional[Dict] = None, microbatch: int = 0,
             extra_tag: str = "", out_dir: Optional[str] = None,
             device: Optional[str] = None) -> Dict:
    """Dry-run one cell on the production mesh; its record, also written
    under `out_dir` when one is given."""
    shape = SHAPES_BY_NAME[shape_name]
    cfg = configure(arch, attention=attention, remat=remat,
                    lin_overrides=lin_overrides,
                    model_overrides=model_overrides)
    kind = cfg.attention.kind if cfg.family != "ssm" else "native"
    reason = skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape_name, "skipped": reason}
    device = device or fake_device()
    chips = 512 if multi_pod else 256
    t0 = time.perf_counter()
    with mesh_lib.fake_world(chips):
        mesh = mesh_lib.make_production_mesh(
            multi_pod=multi_pod, device_type=torch.device(device).type)
        ctx = shd.ParallelCtx(mesh=mesh, fsdp=fsdp if fsdp is not None
                              else mesh_lib.fsdp_for(arch, multi_pod))
        counts = dry_run(cfg, shape, ctx, device=device,
                         microbatch=microbatch)
    wall = time.perf_counter() - t0

    flops = counts["flops"]
    lo, hi = counts["bytes_lower"], counts["bytes_upper"]
    # between perfect fusion and none: their geometric mean, as JAX's
    bytes_accessed = (max(lo, 1.0) * max(hi, 1.0)) ** 0.5
    coll = sum(c["bytes"] for c in counts["collectives"].values())
    rates = mesh_lib.link_rates(mesh.mesh.shape, mesh.mesh_dim_names)
    roofline = {"compute_s": flops / mesh_lib.H100_FLOPS_BF16,
                "memory_s": bytes_accessed / mesh_lib.H100_HBM_BYTES_PER_S,
                "collective_s": sum(
                    c["bytes"] / rates[d]
                    for d, c in counts["collectives_by_dim"].items())}
    useful = model_flops_per_chip(cfg, shape, chips)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "attention_kind": kind, "fsdp": ctx.fsdp, "remat": cfg.remat,
        "tag": extra_tag, "fake_device": device,
        "wall_s": round(wall, 2),
        "argument_bytes": counts["argument_bytes"],
        "argument_bytes_by_part": counts["argument_bytes_by_part"],
        "peak_bytes": counts["peak_bytes"],
        "fits": counts["peak_bytes"] <= DEVICE_BYTES,
        "flops_per_device": flops, "aten_flops": counts["aten_flops"],
        "kernel_flops": counts["kernel_flops"],
        "bytes_accessed_per_device": bytes_accessed,
        "bytes_lower_per_device": lo, "bytes_upper_per_device": hi,
        "collectives": counts["collectives"],
        "collectives_by_dim": counts["collectives_by_dim"],
        "collective_bytes_by_op_dim": counts["collective_bytes_by_op_dim"],
        "collective_bytes_per_device": coll,
        "link_rates": rates,
        "kernels": counts["kernels"],
        "roofline": roofline,
        "roofline_rates": "H100 80GB HBM3 SXM (700 W) datasheet figures, "
                          "not measurements",
        "dominant": max(roofline, key=roofline.get),
        "model_flops_per_chip": useful,
        "useful_flops_ratio": useful / flops if flops else 0.0,
        "tokens": shape.global_batch * (1 if shape.kind == "decode"
                                        else shape.seq_len),
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"-{extra_tag}" if extra_tag else ""
        name = f"{arch}-{shape_name}-{rec['mesh']}-{kind}{tag}"
        with open(os.path.join(out_dir, name + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=tuple(SHAPES_BY_NAME))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--attention", default=None,
                    help="override attention kind (standard baseline)")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--fsdp", default=None,
                    help="override FSDP policy: none|data|pod_data")
    ap.add_argument("--block-slots", type=int, default=None)
    ap.add_argument("--block-size", type=int, default=None)
    ap.add_argument("--seq-shard-acts", action="store_true")
    ap.add_argument("--chunked-ce", type=int, default=0)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--tag", default="")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    lin_ov = {}
    if args.block_slots:
        lin_ov["block_slots"] = args.block_slots
    if args.block_size:
        lin_ov["block_size"] = args.block_size
    model_ov = {}
    if args.seq_shard_acts:
        model_ov["seq_shard_activations"] = True
    if args.chunked_ce:
        model_ov["chunked_ce"] = args.chunked_ce

    if args.all:
        cells = [(a, s, mp) for a in ARCH_IDS for s in SHAPES_BY_NAME
                 for mp in (False, True)]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape, args.multi_pod)]
    else:
        ap.error("give --arch and --shape, or --all")

    failures = 0
    for arch, shape, mp in cells:
        label = f"{arch} × {shape} × {'2x16x16' if mp else '16x16'}"
        try:
            rec = run_cell(arch, shape, multi_pod=mp,
                           attention=args.attention, remat=args.remat,
                           fsdp=args.fsdp, lin_overrides=lin_ov or None,
                           model_overrides=model_ov or None,
                           microbatch=args.microbatch, extra_tag=args.tag,
                           out_dir=ARTIFACT_DIR)
        except Exception:  # a failing cell is reported, the others run
            failures += 1
            sys.stdout.write(f"[dryrun] FAIL {label}\n")
            sys.stdout.write(traceback.format_exc())
            sys.stdout.flush()
            continue
        if "skipped" in rec:
            sys.stdout.write(f"[dryrun] SKIP {label}: {rec['skipped']}\n")
            continue
        r = rec["roofline"]
        sys.stdout.write(
            f"[dryrun] OK   {label} {rec['wall_s']}s "
            f"flops/dev={rec['flops_per_device']:.3e} "
            f"peak/dev={rec['peak_bytes'] / 2**30:.2f}GiB "
            f"args/dev={rec['argument_bytes'] / 2**30:.2f}GiB "
            f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
            f"coll={r['collective_s']:.4f}s dom={rec['dominant']}\n")
        sys.stdout.flush()
    if failures:
        sys.stdout.write(f"[dryrun] {failures} cells failed\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

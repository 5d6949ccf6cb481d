"""Cross-pod gradient reduction with error-feedback int8 compression.

Counterpart of ``repro/train/compressed_dp.py``. Within a pod the
gradient reduction stays exact; across pods only int8 codes (and one fp32
scale a leaf) move, and each pod feeds its quantization error back into
its next step (Karimireddy et al., 2019).

* :func:`compressed_pod_reduce` and :func:`init_residual` are JAX's pure
  functions on an explicit leading pod axis, kept for the residual's
  checkpoint layout and as the rule the per-rank step follows.
* :func:`make_compressed_train_step` is the step on a mesh with a "pod"
  dim (the training layout of parallel/sharding.py). Each pod's gradient
  is reduced over its own data dims only: the step's inner ctx excludes
  "pod", as JAX's does. Each rank then quantizes g + residual (the scale
  from the max over the whole leaf, so over the dims its shard splits
  on), all-gathers the int8 codes and the fp32 scales over "pod", sums
  the codes in int32, scales the sum by the mean scale divided by the
  number of pods, and keeps tot - sent as its residual. What crosses pods
  is int8.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import flatten, nest
from repro_torch.optim import adamw_update, make_schedule
from repro_torch.optim.grad_utils import global_norm, quantize_int8
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.plan import local_batch, resolve_attention_plan
from repro_torch.parallel.sharding import ParallelCtx


def compressed_pod_reduce(grads_pod: Dict, residual_pod: Dict, n_pods: int
                          ) -> Tuple[Dict, Dict]:
    """Error-feedback int8 mean-reduction over an explicit leading pod
    axis. grads_pod: each pod's gradient (n_pods, ...) per leaf;
    residual_pod: the matching feedback state. Returns (the mean-reduced
    fp32 gradient without the pod axis, the new residual)."""
    red, res = {}, {}
    r_flat = flatten(residual_pod)
    for k, g in flatten(grads_pod).items():
        tot = g.to(torch.float32) + r_flat[k]
        qs, scales = zip(*(quantize_int8(t) for t in tot))
        q, scale = torch.stack(qs), torch.stack(scales)
        qsum = q.to(torch.int32).sum(dim=0)
        red[k] = qsum.to(torch.float32) * scale.mean() / n_pods
        sent = q.to(torch.float32) * scale.reshape(
            (n_pods,) + (1,) * (tot.ndim - 1))
        res[k] = tot - sent
    return nest(red), nest(res)


def init_residual(params: Dict, n_pods: int) -> Dict:
    """Per-pod error-feedback state: a zero leading pod axis a leaf."""
    return nest({k: torch.zeros((n_pods,) + tuple(p.shape),
                                dtype=torch.float32, device=p.device)
                 for k, p in flatten(params).items()})


def inner_ctx(ctx: ParallelCtx) -> ParallelCtx:
    """The training layout within a pod: the data dims but "pod"."""
    return dataclasses.replace(ctx, exclude_data_axes=("pod",),
                               sharded=True)


def check_ctx(ctx: ParallelCtx) -> int:
    """The number of pods; raises unless the mesh has a pod dim over which
    the parameters are replicated (so each pod's gradient is defined)."""
    if ctx is None or not ctx.has_pod_axis:
        raise ValueError("compressed DP needs a mesh with a pod axis")
    if "pod" in ctx.fsdp_axes:
        raise ValueError("compressed DP needs params replicated across "
                         "pods (fsdp must not include 'pod')")
    return ctx.width("pod")


def init_local_residual(params: Dict) -> Dict:
    """This rank's residual: zeros shaped like its parameter shards."""
    return nest({k: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
                 for k, p in flatten(params).items()})


@torch.no_grad()
def reduce_across_pods(grads: Dict, residual: Dict, ctx: ParallelCtx
                       ) -> Tuple[Dict, Dict]:
    """The per-rank form of :func:`compressed_pod_reduce`: `grads` is this
    pod's gradient, {key: this rank's shard} flat, emptied as it is
    reduced (a leaf's gradient is freed once its reduction is made);
    `residual` is this rank's feedback state. Returns (the reduced
    gradient's shard, fp32, the new residual)."""
    inner = inner_ctx(ctx)
    pod = ctx.axis("pod")
    n_pods = ctx.width("pod")
    red, res = {}, {}
    r_flat = flatten(residual)
    for k in list(grads):
        g = grads.pop(k)
        tot = g.to(torch.float32) + r_flat[k]
        del g
        axes = shd.sharded_axes(shd.leaf_spec(k, tot.ndim, inner), inner)
        amax = comm.amax(tot.abs().max(), axes)
        q, scale = quantize_int8(tot, amax)
        qs = comm.all_gather_stack(q, pod)              # the cross-pod hop
        scales = comm.all_gather_stack(scale, pod)
        qsum = qs[0].to(torch.int32)                    # one int32 buffer
        for other in qs[1:]:
            qsum += other
        del qs
        red[k] = qsum.to(torch.float32).mul_(scales.mean()).div_(n_pods)
        del qsum
        res[k] = tot.sub_(q.to(torch.float32).mul_(scale))
    return nest(red), nest(res)


def make_compressed_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                               ctx: ParallelCtx) -> Callable:
    """Train step whose cross-pod gradient hop is int8-compressed:
    (params, opt_state, residual, global batch) -> (params, opt_state,
    residual, metrics). `params` are this rank's shards (requiring grad),
    updated in place with the moments; `residual` is this rank's, from
    :func:`init_local_residual`. The loss is each pod's masked mean over
    its own rows; the metrics are averaged over the pods, as JAX's."""
    n_pods = check_ctx(ctx)
    outer = dataclasses.replace(ctx, sharded=True)
    inner = inner_ctx(ctx)
    plan = resolve_attention_plan(cfg.attention, shd.region_ctx(inner))
    sched = make_schedule(opt_cfg)
    pod = (ctx.axis("pod"),)

    def step(params, opt_state, residual, batch):
        loss, metrics = model_lib.loss_fn(
            params, cfg, local_batch(batch, outer), plan=plan, ctx=inner)
        leaves = flatten(params)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)}
        grads, residual = reduce_across_pods(grads, residual, ctx)
        metrics = {k: comm.reduce(v.detach().reshape(1), pod)[0] / n_pods
                   for k, v in metrics.items()}
        # the clip of grad_utils.clip_by_global_norm, in place on the fp32
        # reduced gradient (no second copy of it)
        gnorm = global_norm(grads, outer)
        scale = torch.clamp(opt_cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        for g in flatten(grads).values():
            g.mul_(scale)
        lr = sched(opt_state["step"])
        params, opt_state = adamw_update(grads, opt_state, params, opt_cfg,
                                         lr)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return params, opt_state, residual, metrics

    return step

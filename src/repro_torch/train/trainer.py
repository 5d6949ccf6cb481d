"""Training loop: the train step (with microbatch gradient accumulation in
fp32), checkpoint/auto-resume fault tolerance, preemption handling and a
straggler watchdog.

Counterpart of ``repro/train/trainer.py``, its telemetry included (a
`train_step` span and JSONL record per step, the plan's cost attribution).
The step is eager PyTorch: forward, ``torch.autograd.grad``, global-norm
clip, AdamW in place.

On a mesh (``ctx``, a ParallelCtx over torch.distributed ranks) the step
runs the training layout of parallel/sharding.py: every rank draws the
same global batch and keeps its rows over the data dims; the parameters
and both moments are stored as each rank's shard per ``param_shardings``
(``Trainer._place``), made whole a layer at a time where the model uses
them. A checkpoint holds whole leaves in the JAX package's npz layout:
each leaf is gathered and rank 0 writes it, behind a barrier; a restore
reads the whole checkpoint leaf by leaf and keeps this mesh's shards, so
a run resumes on another mesh (elastic restart). With
``compressed_pod_grads`` on a mesh with a "pod" dim the step is
train/compressed_dp.py's, and the per-rank error-feedback residual is
checkpointed in JAX's (n_pods, ...) layout.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, OptimizerConfig, TrainConfig
from repro_torch.data.pipeline import DataState, SyntheticCorpus, batches
from repro_torch.kernels.common import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import flatten, nest
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               make_schedule)
from repro_torch.parallel import comm
from repro_torch.parallel import plan as plan_lib
from repro_torch.parallel import sharding as shd
from repro_torch.train import compressed_dp
from repro_torch.telemetry import MS_BUCKETS, as_telemetry, plan_attribution

log = logging.getLogger("repro_torch.train")


def training_ctx(ctx):
    """`ctx` in the training layout (None without a mesh)."""
    if ctx is None or ctx.mesh is None:
        return None
    return dataclasses.replace(ctx, sharded=True)


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                    microbatch: int = 0,
                    plan: Optional[plan_lib.AttentionPlan] = None,
                    ctx=None) -> Callable:
    """Build the train step: (params, opt_state, batch) -> (params,
    opt_state, metrics). `params` leaves must require grad; they and the
    moments are updated in place. With microbatch > 0 the global batch is
    split and the gradients accumulated in fp32, each micro-gradient
    divided by the number of microbatches. On a mesh (`ctx`) `params` and
    the moments are this rank's shards and `batch` is the global batch:
    microbatch i is global rows [i·mb, (i+1)·mb), of which the step keeps
    this rank's rows over the data dims."""
    sched = make_schedule(opt_cfg)
    ctx = training_ctx(ctx)
    if plan is None:
        plan = plan_lib.resolve_attention_plan(cfg.attention,
                                               shd.region_ctx(ctx))

    def grads_of(params, batch):
        loss, metrics = model_lib.loss_fn(
            params, cfg, plan_lib.local_batch(batch, ctx), plan=plan,
            ctx=ctx)
        leaves = flatten(params)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)}
        return grads, {k: v.detach() for k, v in metrics.items()}

    def compute_grads(params, batch):
        if not microbatch:
            grads, metrics = grads_of(params, batch)
            return nest(grads), metrics
        gb = batch["labels"].shape[0]
        if gb % microbatch != 0:
            raise ValueError(f"global batch {gb} is not a multiple of "
                             f"microbatch {microbatch}")
        n_micro = gb // microbatch
        acc: Dict[str, torch.Tensor] = {}
        mets: List[Dict[str, torch.Tensor]] = []
        for i in range(n_micro):
            mb = {k: v[i * microbatch:(i + 1) * microbatch]
                  for k, v in batch.items()}
            grads, metrics = grads_of(params, mb)
            for k, g in grads.items():
                g = g.to(torch.float32) / n_micro
                acc[k] = g if k not in acc else acc[k] + g
            mets.append(metrics)
        metrics = {k: torch.stack([m[k] for m in mets]).mean()
                   for k in mets[0]}
        return nest(acc), metrics

    def train_step(params, opt_state, batch):
        grads, metrics = compute_grads(params, batch)
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip, ctx)
        lr = sched(opt_state["step"])
        params, opt_state = adamw_update(grads, opt_state, params, opt_cfg,
                                         lr)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return params, opt_state, metrics

    return train_step


class Trainer:
    """Drives the step function with fault tolerance.

    * auto-resume: at startup the latest complete checkpoint in
      ``checkpoint_dir`` (params, optimizer, data state) is restored.
    * preemption: `preempt_check()` (injectable: a SIGTERM flag, a file
      flag, a test hook) triggers an immediate checkpoint and a clean exit.
    * straggler watchdog: logs steps slower than 2× the running median.

    ``checkpoint_every <= 0`` turns checkpoints off (no resume, no saves).
    `ctx` puts the run on a mesh (see the module docstring).
    The run's per-step records (loss, the MoE aux loss, grad norm, ms,
    tokens/s) are kept in ``history``. Runs on CUDA unless `device` says otherwise.
    `telemetry` (a `Telemetry`; None is the disabled no-op) gets a
    `train_step` span, a `train_step` JSONL record and metrics per step, and
    the plan's cost attribution once.
    """

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, *,
                 device: Union[str, torch.device] = "cuda",
                 preempt_check: Optional[Callable[[], bool]] = None,
                 log_fn: Optional[Callable[[str], None]] = None,
                 attention_backend: Optional[str] = None,
                 backward_impl: Optional[str] = None,
                 telemetry=None, ctx=None):
        # attention_backend / backward_impl override the config's knobs for
        # this run (None keeps them); the plan validates both here, before
        # the first step.
        if attention_backend is not None:
            cfg = cfg.with_attention_backend(attention_backend)
        if backward_impl is not None:
            cfg = cfg.with_backward_impl(backward_impl)
        if cfg.embedding_inputs or cfg.frontend_embed_len > 0:
            raise ValueError(
                f"config {cfg.name!r}: the Trainer's synthetic corpus yields "
                "token batches only; train a frontend config through "
                "make_train_step with a batch holding its embeddings")
        self.device = resolve_device(device)
        self.ctx = training_ctx(ctx)
        self.plan = plan_lib.resolve_attention_plan(
            cfg.attention, shd.region_ctx(self.ctx))
        self.compressed = bool(tcfg.compressed_pod_grads and self.ctx
                               is not None and self.ctx.has_pod_axis)
        self.cfg = cfg
        self.tcfg = tcfg
        # the whole shape of each leaf: the vocabulary may shard unevenly
        self._shapes = {k: shape for k, (shape, *_) in
                        model_lib.param_spec(cfg).items()}
        self.preempt_check = preempt_check or (lambda: False)
        self.log = log_fn or log.info
        self.ckpt = (Checkpointer(tcfg.checkpoint_dir)
                     if tcfg.checkpoint_every > 0 else None)
        self.corpus = SyntheticCorpus(cfg.vocab_size, seed=tcfg.seed)
        self.history: List[Dict[str, float]] = []
        self.telemetry = as_telemetry(telemetry)
        if self.telemetry.enabled:
            rec = plan_attribution(self.plan, cfg.attention,
                                   max_seq=tcfg.seq_len,
                                   batch=tcfg.global_batch)
            self.telemetry.record(rec.pop("kind"), **rec)
        if self.compressed:
            self.train_step = compressed_dp.make_compressed_train_step(
                cfg, tcfg.optimizer, self.ctx)
        else:
            self.train_step = make_train_step(cfg, tcfg.optimizer,
                                              microbatch=tcfg.microbatch,
                                              plan=self.plan, ctx=self.ctx)
        self._residual = None

    # -- state --------------------------------------------------------------

    @property
    def _rank0(self) -> bool:
        return self.ctx is None or dist.get_rank() == 0

    def _place(self, params):
        """On a mesh, this rank's shard of each parameter (the moments are
        then made on the shards; a restore cuts each whole leaf it reads to
        the current mesh's shards, `_local_array`)."""
        if self.ctx is None:
            return params
        return shd.shard_tree(params, self.ctx)

    def init_state(self):
        params = self._place(model_lib.init_params(
            self.cfg, seed=self.tcfg.seed, device=self.device))
        opt_state = adamw_init(params, self.tcfg.optimizer)
        for p in flatten(params).values():
            p.requires_grad_(True)
        if self.compressed:
            self._residual = compressed_dp.init_local_residual(params)
        return params, opt_state, DataState(self.tcfg.seed, 0)

    def _local_array(self, name: str, key: str, arr: np.ndarray):
        """A checkpoint leaf (whole, as saved; a memory map when large) cut
        to this rank's shard: moments by their parameter's spec, the
        residual's own pod first. Only the shard is copied."""
        if self.ctx is None or (name == "opt_state" and key == "step"):
            return arr
        path = key.split("/", 1)[1] if name == "opt_state" else key
        if name == "residual":
            arr = arr[self.ctx.axis("pod").coord]
        return np.ascontiguousarray(
            arr[shd.leaf_slices(path, arr.shape, self.ctx)])

    def restore_or_init(self):
        params, opt_state, dstate = self.init_state()
        latest = self.ckpt.latest_step() if self.ckpt else None
        if latest is None:
            return params, opt_state, dstate, 0
        tmpl = {"params": params, "opt_state": opt_state}
        if self.compressed:
            tmpl["residual"] = self._residual
        restored, meta = self.ckpt.restore(latest, tmpl,
                                           transform=self._local_array)
        params, opt_state = restored["params"], restored["opt_state"]
        if self.compressed:
            self._residual = restored["residual"]
        for p in flatten(params).values():
            p.requires_grad_(True)
        self.log(f"[trainer] resumed from step {latest}")
        return params, opt_state, DataState.from_dict(meta["data_state"]), \
            latest

    @torch.no_grad()
    def _whole(self, tree: Dict) -> Dict:
        """The whole leaves of a tree of shards (parameters, or moments
        keyed like them), a leaf at a time, on the host of rank 0 (an empty
        tree elsewhere)."""
        out = {}
        for k, v in flatten(tree).items():
            spec = shd.leaf_spec(k, v.ndim, self.ctx)
            x = shd.unshard_leaf(v, spec, self.ctx,
                                 shape=self._shapes[k])
            if self._rank0:
                out[k] = x.cpu()
        return nest(out)

    @torch.no_grad()
    def _whole_residual(self) -> Dict:
        """The residual in JAX's (n_pods, ...) layout, on rank 0's host."""
        pod = self.ctx.axis("pod")
        out = {}
        for k, v in flatten(self._residual).items():
            spec = shd.leaf_spec(k, v.ndim, self.ctx)
            x = comm.all_gather_stack(shd.unshard_leaf(
                v, spec, self.ctx, shape=self._shapes[k]), pod)
            if self._rank0:
                out[k] = x.cpu()
        return nest(out)

    def save(self, step, params, opt_state, dstate):
        if self.ckpt is None:
            return
        if self.ctx is None:
            state = {"params": params, "opt_state": opt_state}
        else:
            state = {"params": self._whole(params),
                     "opt_state": {"mu": self._whole(opt_state["mu"]),
                                   "nu": self._whole(opt_state["nu"]),
                                   "step": opt_state["step"]}}
        if self.compressed:
            state["residual"] = self._whole_residual()
        if self._rank0:
            self.ckpt.save(step, state,
                           metadata={"data_state": dstate.to_dict()})
        if self.ctx is not None:
            dist.barrier()

    # -- loop ---------------------------------------------------------------

    def run(self, steps: Optional[int] = None) -> Dict[str, float]:
        tcfg = self.tcfg
        steps = steps if steps is not None else tcfg.steps
        params, opt_state, dstate, start = self.restore_or_init()
        stream = batches(self.corpus, dstate, batch=tcfg.global_batch,
                         seq=tcfg.seq_len, objective=self.cfg.objective)
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        last_metrics: Dict[str, float] = {}
        for step in range(start, steps):
            np_batch, dstate = next(stream)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in np_batch.items()}
            sync()
            t0 = time.perf_counter()
            with self.telemetry.span("train_step", cat="trainer", step=step):
                if self.compressed:
                    params, opt_state, self._residual, metrics = \
                        self.train_step(params, opt_state, self._residual,
                                        batch)
                else:
                    params, opt_state, metrics = self.train_step(
                        params, opt_state, batch)
                # float() is the step's host sync: inside the span and the
                # time, so both cover the device work
                metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self._watchdog(step, dt)
            self._record_step(step, dt, metrics)
            self.history.append({
                "step": step + 1, "loss": metrics["loss"],
                "aux_loss": metrics["aux_loss"],
                "grad_norm": metrics["grad_norm"], "ms": dt * 1e3,
                "tokens_per_s": metrics["tokens"] / dt})
            last_metrics = metrics
            if (step + 1) % tcfg.log_every == 0:
                aux = (f"aux={metrics['aux_loss']:.4f} "
                       if self.cfg.moe.num_experts > 0 else "")
                self.log(f"[trainer] step {step + 1} "
                         f"loss={metrics['loss']:.4f} {aux}"
                         f"gnorm={metrics['grad_norm']:.3f} {dt * 1e3:.0f}ms")
            if tcfg.checkpoint_every > 0 \
                    and (step + 1) % tcfg.checkpoint_every == 0:
                self.save(step + 1, params, opt_state, dstate)
            if self.preempt_check():
                self.save(step + 1, params, opt_state, dstate)
                self.log(f"[trainer] preempted at step {step + 1}; "
                         "checkpointed and exiting")
                last_metrics["preempted_at"] = step + 1
                return last_metrics
        self.save(steps, params, opt_state, dstate)
        self._params = params
        return last_metrics

    def _record_step(self, step: int, dt: float,
                     metrics: Dict[str, float]) -> None:
        """One JSONL record and the histogram, counter and gauge updates
        per executed step (JAX's names and fields)."""
        if not self.telemetry.enabled:
            return
        tokens = metrics["tokens"]
        tokens_per_s = tokens / dt if dt > 0 else 0.0
        self.telemetry.record(
            "train_step", step=step, step_ms=round(dt * 1e3, 3),
            tokens_per_s=round(tokens_per_s, 1),
            loss=metrics.get("loss"), grad_norm=metrics.get("grad_norm"),
            lr=metrics.get("lr"))
        reg = self.telemetry.metrics
        reg.histogram("train_step_ms", buckets=MS_BUCKETS).observe(dt * 1e3)
        reg.counter("train_steps_total").inc()
        reg.counter("train_tokens_total").inc(tokens)
        reg.gauge("train_loss").set(metrics.get("loss", float("nan")))
        reg.gauge("train_grad_norm").set(
            metrics.get("grad_norm", float("nan")))

    def _watchdog(self, step: int, dt: float, factor: float = 2.0):
        """Flag a step slower than `factor` × the median of the last 32
        (once 8 have run, this one included)."""
        times = [h["ms"] * 1e-3 for h in self.history[-31:]] + [dt]
        if len(times) >= 8:
            med = float(np.median(times))
            if dt > factor * med:
                self.log(f"[watchdog] step {step} took {dt:.3f}s "
                         f"(median {med:.3f}s) — straggler")

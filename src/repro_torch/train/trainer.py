"""Training loop: the train step (with microbatch gradient accumulation in
fp32), checkpoint/auto-resume fault tolerance, preemption handling and a
straggler watchdog.

Counterpart of ``repro/train/trainer.py`` on one device: no mesh, no
compressed cross-pod gradients, no telemetry (those come with later slices).
The step is eager PyTorch: forward, ``torch.autograd.grad``, global-norm
clip, AdamW in place.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, OptimizerConfig, TrainConfig
from repro_torch.data.pipeline import DataState, SyntheticCorpus, batches
from repro_torch.kernels.common import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import flatten, nest
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               make_schedule)
from repro_torch.parallel import plan as plan_lib

log = logging.getLogger("repro_torch.train")


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                    microbatch: int = 0,
                    plan: Optional[plan_lib.AttentionPlan] = None
                    ) -> Callable:
    """Build the train step: (params, opt_state, batch) -> (params,
    opt_state, metrics). `params` leaves must require grad; they and the
    moments are updated in place. With microbatch > 0 the global batch is
    split and the gradients accumulated in fp32, each micro-gradient
    divided by the number of microbatches."""
    sched = make_schedule(opt_cfg)

    def grads_of(params, batch):
        loss, metrics = model_lib.loss_fn(params, cfg, batch, plan=plan)
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
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
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
    The run's per-step records (loss, the MoE aux loss, grad norm, ms,
    tokens/s) are kept in ``history``. Runs on CUDA unless `device` says otherwise.
    """

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, *,
                 device: Union[str, torch.device] = "cuda",
                 preempt_check: Optional[Callable[[], bool]] = None,
                 log_fn: Optional[Callable[[str], None]] = None,
                 attention_backend: Optional[str] = None,
                 backward_impl: Optional[str] = None):
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
        if tcfg.compressed_pod_grads:
            raise ValueError("compressed_pod_grads needs a multi-GPU mesh, "
                             "which the port does not have yet")
        self.device = resolve_device(device)
        self.plan = plan_lib.resolve_attention_plan(cfg.attention)
        self.cfg = cfg
        self.tcfg = tcfg
        self.preempt_check = preempt_check or (lambda: False)
        self.log = log_fn or log.info
        self.ckpt = (Checkpointer(tcfg.checkpoint_dir)
                     if tcfg.checkpoint_every > 0 else None)
        self.corpus = SyntheticCorpus(cfg.vocab_size, seed=tcfg.seed)
        self.history: List[Dict[str, float]] = []
        self.train_step = make_train_step(cfg, tcfg.optimizer,
                                          microbatch=tcfg.microbatch,
                                          plan=self.plan)

    # -- state --------------------------------------------------------------

    def init_state(self):
        params = model_lib.init_params(self.cfg, seed=self.tcfg.seed,
                                       device=self.device)
        for p in flatten(params).values():
            p.requires_grad_(True)
        opt_state = adamw_init(params, self.tcfg.optimizer)
        return params, opt_state, DataState(self.tcfg.seed, 0)

    def restore_or_init(self):
        params, opt_state, dstate = self.init_state()
        latest = self.ckpt.latest_step() if self.ckpt else None
        if latest is None:
            return params, opt_state, dstate, 0
        restored, meta = self.ckpt.restore(
            latest, {"params": params, "opt_state": opt_state})
        params, opt_state = restored["params"], restored["opt_state"]
        for p in flatten(params).values():
            p.requires_grad_(True)
        self.log(f"[trainer] resumed from step {latest}")
        return params, opt_state, DataState.from_dict(meta["data_state"]), \
            latest

    def save(self, step, params, opt_state, dstate):
        if self.ckpt is not None:
            self.ckpt.save(step, {"params": params, "opt_state": opt_state},
                           metadata={"data_state": dstate.to_dict()})

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
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                         batch)
            # float() is the step's host sync: the time covers device work
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self._watchdog(step, dt)
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

    def _watchdog(self, step: int, dt: float, factor: float = 2.0):
        """Flag a step slower than `factor` × the median of the last 32
        (once 8 have run, this one included)."""
        times = [h["ms"] * 1e-3 for h in self.history[-31:]] + [dt]
        if len(times) >= 8:
            med = float(np.median(times))
            if dt > factor * med:
                self.log(f"[watchdog] step {step} took {dt:.3f}s "
                         f"(median {med:.3f}s) — straggler")

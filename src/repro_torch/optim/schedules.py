"""Learning-rate schedules (pure functions of the step).

Copy of ``repro/optim/schedules.py``, computed on the host in float32 as
the JAX package computes it on the device: the step counter lives on the
host, so the learning rate costs no device sync.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import OptimizerConfig


def make_schedule(cfg: OptimizerConfig):
    """lr_at(step) -> 0-d float32 CPU tensor: linear warmup, then cosine,
    linear or constant decay to total_steps."""
    if cfg.schedule not in ("cosine", "linear", "constant"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")

    def lr_at(step) -> torch.Tensor:
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
        span = max(cfg.total_steps - cfg.warmup_steps, 1)
        frac = torch.clamp((s - cfg.warmup_steps) / span, 0.0, 1.0)
        if cfg.schedule == "constant":
            decay = torch.ones((), dtype=torch.float32)
        elif cfg.schedule == "linear":
            decay = 1.0 - frac
        else:  # cosine
            decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return cfg.lr * warm * decay

    return lr_at

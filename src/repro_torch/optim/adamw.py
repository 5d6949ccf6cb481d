"""AdamW over nested dicts of tensors.

Counterpart of ``repro/optim/adamw.py``. Moments are stored in
``moment_dtype`` (bf16 halves optimizer memory); the update math always runs
in fp32; decoupled weight decay applies to matrices only (ndim >= 2). The
port updates parameters and moments in place, leaf by leaf, so the step
needs fp32 temporaries for one leaf at a time rather than a second copy of
the model. The step counter is a 0-d int32 CPU tensor, so the bias
corrections and the learning rate are host scalars.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.models.transformer import flatten, nest, torch_dtype


def adamw_init(params: Dict, cfg: OptimizerConfig) -> Dict:
    mdt = torch_dtype(cfg.moment_dtype)
    zeros = {k: torch.zeros(p.shape, dtype=mdt, device=p.device)
             for k, p in flatten(params).items()}
    return {"mu": nest(zeros),
            "nu": nest({k: torch.zeros_like(z) for k, z in zeros.items()}),
            "step": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def adamw_update(grads: Dict, opt_state: Dict, params: Dict,
                 cfg: OptimizerConfig, lr) -> Tuple[Dict, Dict]:
    """One AdamW step with learning rate `lr` (the schedule's value).
    Updates `params` and the moments of `opt_state` in place and returns
    (params, opt_state) with the step counter advanced."""
    step = opt_state["step"] + 1
    s32 = step.to(torch.float32)
    b1, b2 = cfg.b1, cfg.b2
    c1 = float(1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), s32))
    c2 = float(1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), s32))
    lr = float(lr)
    gs, mus, nus = (flatten(t) for t in (grads, opt_state["mu"],
                                         opt_state["nu"]))
    for key, p in flatten(params).items():
        g32 = gs[key].to(torch.float32)
        mu, nu = mus[key], nus[key]
        # .to() is a no-op on fp32 moments, which are then updated in place
        mu32 = mu.to(torch.float32).mul_(b1).add_(g32, alpha=1 - b1)
        nu32 = nu.to(torch.float32).mul_(b2).addcmul_(g32, g32,
                                                      value=1 - b2)
        delta = (mu32 / c1).div_((nu32 / c2).sqrt_().add_(cfg.eps))
        p32 = p.to(torch.float32)
        if p.ndim >= 2:
            delta.add_(p32, alpha=cfg.weight_decay)
        p.copy_(p32.sub_(delta, alpha=lr))
        mu.copy_(mu32)
        nu.copy_(nu32)
    return params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                    "step": step}


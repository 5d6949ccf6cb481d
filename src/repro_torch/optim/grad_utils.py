"""Gradient utilities: global norm and global-norm clipping.

Copy of ``repro/optim/grad_utils.py:13-25``. Both stay on the device (no
host sync). The JAX module's error-feedback int8 compression serves
cross-pod reductions and comes with the multi-GPU slice.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.transformer import flatten, nest


def global_norm(tree: Dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    leaves = flatten(tree).values()
    return torch.sqrt(sum(torch.square(x.to(torch.float32)).sum()
                          for x in leaves))


def clip_by_global_norm(grads: Dict, max_norm: float
                        ) -> Tuple[Dict, torch.Tensor]:
    """Scale every leaf by min(1, max_norm / global norm), in fp32, cast
    back to the leaf's dtype. Returns (new tree, global norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return nest({k: (g.to(torch.float32) * scale).to(g.dtype)
                 for k, g in flatten(grads).items()}), gn

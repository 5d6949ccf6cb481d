"""Gradient utilities: global norm, global-norm clipping, and the
error-feedback int8 compression of cross-pod gradient reductions.

Copy of ``repro/optim/grad_utils.py``. Everything stays on the device (no
host sync). Under the training layout (``ctx.sharded``, see
parallel/sharding.py) each leaf is this rank's shard, and the global norm
sums each leaf's squares over the mesh dims that leaf is sharded on, and
over no other. The int8 quantizer rounds half to even, as ``jnp.round``
does, so its codes equal the JAX package's bit for bit on the same fp32
input.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.transformer import flatten, nest
from repro_torch.parallel import comm
from repro_torch.parallel import sharding


def global_norm(tree: Dict, ctx=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32; with a sharded
    ctx, of the whole leaves this rank holds shards of."""
    leaves = flatten(tree)
    if not sharding.is_sharded(ctx):
        return torch.sqrt(sum(torch.square(x.to(torch.float32)).sum()
                              for x in leaves.values()))
    groups: Dict[tuple, torch.Tensor] = {}
    for key, x in leaves.items():
        axes = sharding.sharded_axes(sharding.leaf_spec(key, x.ndim, ctx),
                                     ctx)
        sq = torch.square(x.to(torch.float32)).sum()
        groups[axes] = groups[axes] + sq if axes in groups else sq
    return torch.sqrt(sum(comm.reduce(sq.reshape(1), axes)[0]
                          for axes, sq in groups.items()))


def clip_by_global_norm(grads: Dict, max_norm: float, ctx=None
                        ) -> Tuple[Dict, torch.Tensor]:
    """Scale every leaf by min(1, max_norm / global norm), in fp32, cast
    back to the leaf's dtype. Returns (new tree, global norm)."""
    gn = global_norm(grads, ctx)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return nest({k: (g.to(torch.float32) * scale).to(g.dtype)
                 for k, g in flatten(grads).items()}), gn


# ---------------------------------------------------------------------------
# Error-feedback int8 compression (cross-pod reductions)
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization. Returns (q, scale). `amax`
    overrides max|x| (a shard of a tensor passes the whole tensor's)."""
    x32 = x.to(torch.float32)
    if amax is None:
        amax = x32.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grads: Dict, residual: Optional[Dict]
                           ) -> Tuple[Dict, Dict]:
    """Error-feedback compression: quantize (g + residual); the quantization
    error is the next step's residual (Karimireddy et al., 2019). Returns
    ({leaf: {"q", "scale"}} tree, new residual tree)."""
    g_flat = flatten(grads)
    r_flat = (flatten(residual) if residual is not None else
              {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
               for k, g in g_flat.items()})
    comp, res = {}, {}
    for k, g in g_flat.items():
        tot = g.to(torch.float32) + r_flat[k]
        q, s = quantize_int8(tot)
        comp[k] = {"q": q, "scale": s}
        res[k] = tot - dequantize_int8(q, s)
    return nest(comp), nest(res)


def decompress(comp: Dict) -> Dict:
    """The fp32 tree of a `compress_with_feedback` payload."""
    def walk(node):
        if set(node) == {"q", "scale"} and not isinstance(node["q"], dict):
            return dequantize_int8(node["q"], node["scale"])
        return {k: walk(v) for k, v in node.items()}
    return walk(comp)

"""FakeTensor stand-ins for the inputs of every (arch × shape) cell.

Counterpart of ``repro/launch/specs.py``. ``input_specs(cfg, shape)`` is
the global batch of a train or prefill cell, or ``(batch_t, cache)`` of a
decode cell (one new token a row, the cache from ``init_cache`` at the
shape's sequence length); ``batch_specs(cfg, shape, ctx)`` is this rank's
share of the same, its rows over the data dims
(``plan.data_batch_pspec``) and, for a decode cell, its cache laid out per
the attention plan's ``cache_pspecs`` (the KV heads over tp). Every tensor
is a FakeTensor of `mode`: shapes and dtypes, no memory. Token batches are
int32, embeddings in the config's dtype, the cache bf16, as JAX's specs.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import torch_dtype
from repro_torch.parallel import plan as plan_lib
from repro_torch.parallel import sharding as shd


def batch_shapes(cfg: ModelConfig, *, batch: int, seq: int
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{leaf: (shape, dtype)} of one training batch of this architecture
    (JAX's ``make_train_batch_shapes``)."""
    i32, f = torch.int32, torch_dtype(cfg.dtype)
    if cfg.embedding_inputs:
        return {"embeds": ((batch, seq, cfg.d_model), f),
                "labels": ((batch, seq), i32),
                "loss_mask": ((batch, seq), i32)}
    text = seq - cfg.frontend_embed_len
    shapes = {"tokens": ((batch, text), i32)}
    if cfg.frontend_embed_len > 0:
        shapes["frontend_embeds"] = ((batch, cfg.frontend_embed_len,
                                      cfg.d_model), f)
    shapes["labels"] = ((batch, text), i32)
    shapes["loss_mask"] = ((batch, text), i32)
    return shapes


def _fake(mode, shape, dtype, device) -> torch.Tensor:
    with mode:
        return torch.empty(shape, dtype=dtype, device=device)


def _decode_inputs(cfg: ModelConfig, rows: int, seq: int, mode, device,
                   plan: Optional[plan_lib.AttentionPlan],
                   ctx: Optional[shd.ParallelCtx] = None) -> Dict:
    with mode:
        cache = model_lib.init_cache(cfg, batch=rows, max_seq=seq,
                                     dtype=torch.bfloat16, device=device,
                                     plan=plan, ctx=ctx)
    if cfg.embedding_inputs:
        batch_t = {"embeds": _fake(mode, (rows, 1, cfg.d_model),
                                   torch_dtype(cfg.dtype), device)}
    else:
        batch_t = {"tokens": _fake(mode, (rows, 1), torch.int32, device)}
    return {"batch_t": batch_t, "cache": cache}


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, mode,
                device: str) -> Dict:
    """The global inputs of a cell, as FakeTensors of `mode` on `device`:
    the batch of a train or prefill cell, ``{"batch_t", "cache"}`` of a
    decode cell (one token a row, a cache of shape.seq_len whole)."""
    if shape.kind in ("train", "prefill"):
        return {k: _fake(mode, s, dt, device) for k, (s, dt) in batch_shapes(
            cfg, batch=shape.global_batch, seq=shape.seq_len).items()}
    return _decode_inputs(cfg, shape.global_batch, shape.seq_len, mode,
                          device, None)


def local_rows(n: int, ctx: Optional[shd.ParallelCtx]) -> int:
    """This rank's rows of an `n`-row batch over the data dims (all of
    them when the dims do not divide n, as JAX's `_divisible`
    replicates)."""
    if ctx is None or ctx.mesh is None:
        return n
    w = 1
    for a in ctx.data_axes:
        w *= ctx.width(a)
    return n // w if n % w == 0 and n >= w else n


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                ctx: Optional[shd.ParallelCtx], *, mode, device: str,
                plan: Optional[plan_lib.AttentionPlan] = None) -> Dict:
    """This rank's share of `input_specs`: the rows of every batch leaf
    over the data dims (``plan.data_batch_pspec``); for a decode cell the
    batch and a cache of those rows, laid out per `plan`'s cache_pspecs
    (this rank's KV heads over tp) and, under the training layout
    (``ctx.sharded``), the ssm and hybrid families' recurrent states by
    heads over the model dim (JAX's cache specs)."""
    rows = local_rows(shape.global_batch, ctx)
    if shape.kind in ("train", "prefill"):
        return {k: _fake(mode, (rows,) + s[1:], dt, device)
                for k, (s, dt) in batch_shapes(
                    cfg, batch=shape.global_batch,
                    seq=shape.seq_len).items()}
    return _decode_inputs(cfg, rows, shape.seq_len, mode, device, plan, ctx)

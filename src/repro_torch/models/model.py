"""Unified model API and the device-resident decode loop.

Counterpart of ``repro/models/model.py`` for the dense family. Entry points
take an explicit device; randomness comes from an explicit
``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import transformer
from repro_torch.parallel import plan as plan_lib

_TRANSFORMER_FAMILIES = ("dense",)


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> Dict:
    """Random parameters drawn from a torch.Generator seeded with `seed`,
    on `device` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return transformer.init_params(cfg, generator=gen, device=dev)


def forward(params, cfg: ModelConfig, batch: Dict, **kw):
    return transformer.forward(params, cfg, batch, **kw)


def init_cache(cfg: ModelConfig, *, batch: int, max_seq: int,
               dtype=torch.bfloat16,
               device: Union[str, torch.device] = "cuda") -> Dict:
    return transformer.init_cache(cfg, batch=batch, max_seq=max_seq,
                                  dtype=dtype, device=resolve_device(device))


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache: Dict,
                *, plan: Optional[plan_lib.AttentionPlan] = None):
    return transformer.decode_step(params, cfg, tokens, cache, plan=plan)


def decode_scan(
    params,
    cfg: ModelConfig,
    cur: torch.Tensor,        # (B,) int — first un-emitted sampled token
    finished: torch.Tensor,   # (B,) bool — rows whose output is frozen to eos
    cache: Dict,
    *,
    n_steps: int,
    eos_id: int,
    plan: Optional[plan_lib.AttentionPlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, Dict]:
    """Device-resident multi-token greedy decode: `n_steps` decode steps
    with on-device argmax and on-device EOS masking. Nothing here waits for
    the device: the caller syncs ONCE per chunk on the returned tensors.

    Each step emits `cur` (frozen to eos_id for finished rows), feeds it back
    through `decode_step`, and samples the next token. Finished rows freeze
    their position counter (cache["lengths"]), so an idle slot of a pool
    never advances past the cache capacity. A per-row `bad` flag latches
    when a still-live row's logits go non-finite.
    Returns (tokens (B, n_steps), next cur, finished, bad, cache)."""
    plan = plan if plan is not None \
        else plan_lib.resolve_attention_plan(cfg.attention)
    bad = torch.zeros_like(finished)
    toks = []
    for _ in range(n_steps):
        tok = torch.where(finished, torch.full_like(cur, eos_id), cur)
        finished = finished | (tok == eos_id)
        prev_lengths = cache["lengths"]
        logits, cache = decode_step(params, cfg, tok[:, None], cache,
                                    plan=plan)
        cache["lengths"] = torch.where(finished, prev_lengths,
                                       cache["lengths"])
        last = logits[:, 0]
        bad = bad | (~torch.isfinite(last).all(dim=-1) & ~finished)
        cur = torch.argmax(last, dim=-1).to(cur.dtype)
        toks.append(tok)
    return torch.stack(toks, dim=1), cur, finished, bad, cache

"""Zamba2-style hybrid (the hybrid family): a trunk of Mamba2 blocks with
ONE weight-shared attention + MLP block invoked after every
`hybrid_attn_every` trunk layers.

Counterpart of ``repro/models/zamba.py``. Parameters follow JAX's pytree:
``embed/tok``, ``trunk/ln/scale`` and ``trunk/ssm/*`` stacked over the
trunk layers, ``shared_block/{ln1,ln2,attn,mlp}`` stored once, the
layerwise-shared Linformer E under ``shared/lin/E`` (one E for keys and
values, as JAX's ``init_linformer_params`` builds it), ``final_norm`` and
``lm_head``. The shared block is the port's transformer block
(`transformer.apply_block`): its blockwise-causal Linformer attention runs
kernel 1 at prefill (1r and 2 in training) and kernel 3 at decode, once
per invocation.

The decode cache is JAX's: ``mamba_ssm`` (L, B, H, N, P) fp32,
``mamba_conv`` (L, B, W-1, C) in the cache dtype, ``attn`` with one
compressed-cache entry per invocation (leaves (n_inv, B, ...), no
per-row lengths), and one scalar ``length`` shared by every row (serving
falls back to the static bucketed path). `forward(return_cache=True)`
fills the attention entries in the same pass, from the same k/v (the
port's single-pass `cache_entry`), where JAX runs a second
``prefill_cache_entries`` pass: the same entries. Remat wraps the trunk
blocks only, as in JAX; the shared block has none. As in JAX, a sequence
of S >= 8192 (JAX's literal, not the tuned threshold) runs the shared
block's reference route in the memory-bounded chunked form.

Under the training layout (``ctx.sharded``: this rank's rows and its
shard of every parameter) with a model dim, `forward` and `decode_step`
run tensor-parallel: the shared block as transformer.py's blocks, and
each trunk layer's Mamba2 on this rank's heads (`mamba2.apply_mamba2`
and `step_mamba2` with `tp`), JAX's layout of ``ssm/*``. The decode
cache follows JAX's specs: ``mamba_ssm`` holds this rank's heads,
``mamba_conv`` every channel. Where the model width does not divide the
Mamba2 heads, the trunk takes the gathered route (`ssm_axis`): its
leaves are gathered whole and the block runs whole on every rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import linformer as lin_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models import transformer as T
from repro_torch.parallel import plan as plan_lib
from repro_torch.parallel import sharding as shd


def n_attn_invocations(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.hybrid_attn_every


def ssm_axis(cfg: ModelConfig, ctx) -> Tuple[object, bool]:
    """sharding.heads_axis of the trunk's Mamba2 heads."""
    return shd.heads_axis(m2.dims(cfg.d_model, cfg.ssm)[1], ctx)


def param_spec(cfg: ModelConfig) -> T.Spec:
    """Flat {key: (shape, init kind, dtype)}, keyed as the JAX
    checkpointer's (``trunk/ssm/w_in``, ``shared_block/attn/wq``,
    ``shared/lin/E``, ...)."""
    d, nl, V = cfg.d_model, cfg.num_layers, cfg.padded_vocab_size
    dt = T.torch_dtype(cfg.dtype)
    spec: T.Spec = {"embed/tok": ((V, d), T._EMBED, dt)}
    trunk = {"ln/scale": ((d,), T._ONES, dt)}
    for key, val in m2.mamba2_spec(d, cfg.ssm, dt).items():
        trunk[f"ssm/{key}"] = val
    for key, (shape, kind, ldt) in trunk.items():
        spec[f"trunk/{key}"] = ((nl,) + shape, kind, ldt)
    lin = lin_lib.linformer_param_shapes(cfg.attention, num_layers=1,
                                         max_seq=cfg.max_seq_len)
    own = {n: shape[1:] for n, shape in lin.get("per_layer", {}).items()}
    for key, val in T._block_spec(cfg, own).items():
        spec[f"shared_block/{key}"] = val
    for name, shape in lin.get("shared", {}).items():
        spec[f"shared/lin/{name}"] = (shape, T._LIN, dt)
    spec["final_norm/scale"] = ((d,), T._ONES, dt)
    spec["lm_head"] = ((d, V), T._DENSE, dt)
    return spec


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device: torch.device) -> Dict:
    return T.init_from_spec(param_spec(cfg), cfg, generator=generator,
                            device=device)


def forward(params: Dict, cfg: ModelConfig, batch: Dict, *,
            return_cache: bool = False, cache_max_seq: Optional[int] = None,
            cache_dtype=torch.bfloat16,
            plan: Optional[plan_lib.AttentionPlan] = None, ctx=None
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """Full-sequence forward. Returns (logits (B, S, V), a zero aux loss,
    cache|None). With return_cache (S a multiple of the Linformer
    block) the cache holds each trunk layer's state after the last token
    and each invocation's compressed entry, at length = S."""
    rctx = shd.region_ctx(ctx)
    plan = plan if plan is not None \
        else plan_lib.resolve_attention_plan(cfg.attention, rctx)
    # under the training layout the shared block runs tensor-parallel as
    # transformer.py's blocks, and the trunk on this rank's heads
    plan = T.tp_plan(cfg, plan, ctx)
    tp, kv = shd.tensor_axis(ctx), T.whole_kv(cfg, ctx)
    ssm_tp, ssm_whole = ssm_axis(cfg, ctx)
    x = T.embed_lookup(params, batch["tokens"], ctx, cfg.padded_vocab_size)
    B, S, _ = x.shape
    # JAX's literal threshold (not the tuned one) for the shared block's
    # chunked reference form
    chunked = S >= 8192
    shared_lin = T._shared_lin(params, ctx)
    every, n_inv = cfg.hybrid_attn_every, n_attn_invocations(cfg)
    cache = None
    if return_cache:
        cache = init_cache(cfg, batch=B,
                           max_seq=cache_max_seq or cfg.max_seq_len,
                           dtype=cache_dtype, device=x.device, plan=plan,
                           ctx=ctx)
    trunk = T.flatten(params["trunk"])
    keys = list(trunk)

    def mamba_body(h, *leaves):
        lp = T.nest(T.whole_layer(dict(zip(keys, leaves)), ctx, "trunk/",
                                  1, ssm_whole=ssm_whole))
        y = m2.apply_mamba2(lp["ssm"], L.rms_norm(lp["ln"], h), cfg.ssm,
                            return_state=return_cache, tp=ssm_tp)
        if return_cache:
            y, st = y
            return h + y, st["ssm"], st["conv"]
        return h + y

    block = T.remat_wrap(mamba_body, cfg.remat)
    per_layer = [leaf.unbind(0) for leaf in trunk.values()]

    def run_trunk(x, lo, hi):
        for i in range(lo, hi):
            out = block(x, *(views[i] for views in per_layer))
            if return_cache:
                x, cache["mamba_ssm"][i], cache["mamba_conv"][i] = out
            else:
                x = out
        return x

    for g in range(n_inv):
        x = run_trunk(x, g * every, (g + 1) * every)
        entry = None if cache is None else {
            k: v[g] for k, v in cache["attn"].items()}
        x, _ = T.apply_block(
            T.whole_layer(params["shared_block"], ctx, "shared_block/",
                          kv_whole=kv), x,
            cfg, shared_lin=shared_lin, cache_entry=entry, plan=plan,
            chunked_attn=chunked, ctx=rctx, tp=tp)
    x = run_trunk(x, n_inv * every, cfg.num_layers)
    logits = T.logits_from_hidden(params, cfg, x, ctx)
    if cache is not None:
        cache["length"].fill_(S)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=x.device), cache


def init_cache(cfg: ModelConfig, *, batch: int, max_seq: int,
               dtype=torch.bfloat16, device: torch.device,
               plan: Optional[plan_lib.AttentionPlan] = None, ctx=None
               ) -> Dict:
    """A zero decode cache: each trunk layer's Mamba2 state, and each
    invocation's attention entry, laid out per `plan`'s cache_pspecs (this
    rank's heads on a tp mesh) when it is a compressed one. Under the
    training layout `ctx` (see the module docstring) ``mamba_ssm`` holds
    this rank's Mamba2 heads."""
    d_inner, _, P_ = m2.dims(cfg.d_model, cfg.ssm)
    H = m2.shard(cfg.d_model, cfg.ssm, ssm_axis(cfg, ctx)[0]).H
    N = cfg.ssm.state_dim
    nl = cfg.num_layers
    spec = attn_lib.decode_cache_spec(
        cfg.attention, num_layers=n_attn_invocations(cfg), batch=batch,
        max_seq=max_seq, dtype=dtype)
    attn = {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in spec.items() if k != "lengths"}
    if plan is not None and cfg.attention.kind == "linformer_causal":
        attn = plan.place_cache(attn)
    return {
        "mamba_ssm": torch.zeros((nl, batch, H, N, P_),
                                 dtype=torch.float32, device=device),
        "mamba_conv": torch.zeros((nl, batch, cfg.ssm.conv_width - 1,
                                   d_inner + 2 * N), dtype=dtype,
                                  device=device),
        "attn": attn,
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def decode_step(params: Dict, cfg: ModelConfig,
                tokens: Optional[torch.Tensor], cache: Dict, *,
                embeds: Optional[torch.Tensor] = None,
                plan: Optional[plan_lib.AttentionPlan] = None, ctx=None
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step on tokens (B, 1), every row at the cache's scalar
    length. The cache leaves are updated in place; the returned dict
    carries ``length`` + 1. Returns (logits (B, 1, V), cache). Under the
    training layout (`ctx.sharded`) the rows are this rank's, the
    parameters its shards and the cache laid out as init_cache lays it
    out with `ctx` and the plan tp_plan gives; the step runs
    tensor-parallel and gathers the logits whole, as
    transformer.decode_step."""
    plan = plan if plan is not None \
        else plan_lib.resolve_attention_plan(cfg.attention,
                                             shd.region_ctx(ctx))
    plan = T.tp_plan(cfg, plan, ctx)
    tp, kv, rctx = shd.tensor_axis(ctx), T.whole_kv(cfg, ctx), \
        shd.region_ctx(ctx)
    ssm_tp, ssm_whole = ssm_axis(cfg, ctx)
    t = cache["length"]
    x = T.embed_lookup(params, tokens, ctx, cfg.padded_vocab_size)
    rows_t = t.expand(x.shape[0]).contiguous()       # (B,) for the attention
    shared_lin = T._shared_lin(params, ctx)
    every, n_inv = cfg.hybrid_attn_every, n_attn_invocations(cfg)

    def trunk_step(x, i):
        lp = T.nest(T.whole_layer(T.flatten(T.layer_slice(params["trunk"],
                                                          i)),
                                  ctx, "trunk/", 1, ssm_whole=ssm_whole))
        y, st = m2.step_mamba2(
            lp["ssm"], L.rms_norm(lp["ln"], x),
            {"ssm": cache["mamba_ssm"][i], "conv": cache["mamba_conv"][i]},
            cfg.ssm, tp=ssm_tp)
        cache["mamba_ssm"][i] = st["ssm"]
        cache["mamba_conv"][i] = st["conv"]
        return x + y

    for g in range(n_inv):
        for i in range(g * every, (g + 1) * every):
            x = trunk_step(x, i)
        x = T.apply_block_decode(
            T.whole_layer(params["shared_block"], ctx, "shared_block/",
                          kv_whole=kv), x,
            {k: v[g] for k, v in cache["attn"].items()}, rows_t, cfg,
            shared_lin=shared_lin, plan=plan, ctx=rctx, tp=tp)
    for i in range(n_inv * every, cfg.num_layers):
        x = trunk_step(x, i)
    logits = T.gather_logits(T.logits_from_hidden(params, cfg, x, ctx), cfg,
                             ctx)
    return logits, {**cache, "length": t + 1}

"""RWKV6 full model (the attention-free ssm family).

Counterpart of ``repro/models/rwkv_model.py``: token embedding, a stack of
RWKV6 blocks (RMSNorm -> time mix, RMSNorm -> channel mix, each residual),
the final norm and the LM head. Parameters follow JAX's pytree: ``embed/tok``,
``layers/{ln1,ln2}/scale`` and ``layers/rwkv/*`` stacked over the layers,
``final_norm/scale``, ``lm_head``. No attention runs, so no kernel of the
port launches on this family's paths; the recurrences are plain torch, as
JAX's are plain jnp.

The decode cache is JAX's: ``wkv`` (L, B, H, P, P) fp32, ``tm_shift`` and
``cm_shift`` (L, B, D), and one scalar ``length`` shared by every row (no
per-row positions: serving falls back to the static bucketed path). The
shifts take the dtype JAX gives them: the cache dtype from `init_cache`,
the model dtype from `forward` and after a decode step (the last input of
each mix); `decode_step` writes its states into the cache's leaves in place.

Under the training layout (``ctx.sharded``: this rank's rows and its
shard of every parameter) `forward` and `decode_step` gather a layer's
FSDP dims inside the (remat'd) body (transformer.whole_layer) and, with a
model dim, run every block tensor-parallel on this rank's heads, JAX's
layout of ``rwkv/*``: the time mix's projections column-parallel and
``w_o`` row-parallel, ``cm_w_k`` column- and ``cm_w_v`` row-parallel,
the gate through sharding.column_matmul (`rwkv6.time_mix`,
`step_time_mix` and `channel_mix` with `tp`), the head
vocabulary-parallel. The decode cache follows JAX's specs: ``wkv`` holds
this rank's heads, ``tm_shift`` and ``cm_shift`` are whole. Where the
model width does not divide the heads, the blocks take the gathered
route (`ssm_axis`): their leaves are gathered whole and every rank runs
them whole.
"""
from __future__ import annotations

import contextlib
import importlib
import types
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as r6
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as shd


# the modules of this family's forward and loss that name torch.float32
_FP32_MODULES = ("repro_torch.models.rwkv6", "repro_torch.models.rwkv_model",
                 "repro_torch.models.model", "repro_torch.models.transformer",
                 "repro_torch.models.layers")


_TORCH = torch      # float64_reference replaces this module's `torch` too


class _Torch64(types.ModuleType):
    """`torch` with float32 read as float64."""

    def __getattr__(self, name):
        return _TORCH.float64 if name == "float32" else getattr(_TORCH, name)


@contextlib.contextmanager
def float64_reference():
    """Within it, this family's forward and loss read every
    `torch.float32` they name as float64: with float64 weights, the same
    code end to end in fp64 (the time mix takes WKV_DTYPE[float64]). The
    oracle the fp32 gradients are held to
    (tests/test_torch_rwkv_precision.py, chip_smoke's [train-ssm-parity]);
    it patches module globals, so run nothing else meanwhile."""
    mods = [importlib.import_module(m) for m in _FP32_MODULES]
    saved = [m.torch for m in mods]
    for m in mods:
        m.torch = _Torch64("torch64")
    try:
        yield
    finally:
        for m, t in zip(mods, saved):
            m.torch = t


def param_spec(cfg: ModelConfig) -> T.Spec:
    """Flat {key: (shape, init kind, dtype)}, keyed as the JAX
    checkpointer's (``layers/rwkv/tm_w2``, ...)."""
    d, nl, V = cfg.d_model, cfg.num_layers, cfg.padded_vocab_size
    dt = T.torch_dtype(cfg.dtype)
    spec: T.Spec = {"embed/tok": ((V, d), T._EMBED, dt)}
    layer = {"ln1/scale": ((d,), T._ONES, dt),
             "ln2/scale": ((d,), T._ONES, dt)}
    for key, val in r6.rwkv6_spec(d, cfg.mlp.d_ff, dt).items():
        layer[f"rwkv/{key}"] = val
    for key, (shape, kind, ldt) in layer.items():
        spec[f"layers/{key}"] = ((nl,) + shape, kind, ldt)
    spec["final_norm/scale"] = ((d,), T._ONES, dt)
    spec["lm_head"] = ((d, V), T._DENSE, dt)
    return spec


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device: torch.device) -> Dict:
    return T.init_from_spec(param_spec(cfg), cfg, generator=generator,
                            device=device)


def ssm_axis(cfg: ModelConfig, ctx) -> Tuple[object, bool]:
    """sharding.heads_axis of the blocks' RWKV6 heads."""
    return shd.heads_axis(cfg.d_model // cfg.rwkv.head_dim, ctx)


def forward(params: Dict, cfg: ModelConfig, batch: Dict, *,
            return_cache: bool = False, cache_max_seq: Optional[int] = None,
            cache_dtype=torch.bfloat16, plan=None, ctx=None
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """Full-sequence forward from zero state. Returns (logits (B, S, V), a
    zero aux loss, cache|None). Each block runs under the config's
    remat policy when autograd records. With return_cache the cache holds
    the states after the last token (JAX's leaves and dtypes) at
    length = S. `cache_max_seq`, `cache_dtype` and `plan` are taken for the
    common model API: the state has no sequence axis and no attention
    runs. `ctx`: see the module docstring (no region opens: no attention
    runs); under tensor parallelism the logits are this rank's vocabulary
    shard (transformer.vocab_range)."""
    tp, ssm_whole = ssm_axis(cfg, ctx)
    x = T.embed_lookup(params, batch["tokens"], ctx, cfg.padded_vocab_size)
    B, S, D = x.shape
    zero_shift = x.new_zeros((B, D))
    H = r6.heads(D, cfg.rwkv, tp)[0]
    zero_wkv = x.new_zeros((B, H, cfg.rwkv.head_dim, cfg.rwkv.head_dim),
                           dtype=torch.float32)
    layers = T.flatten(params["layers"])
    keys = list(layers)

    def body(h, *leaves):
        lp = T.nest(T.whole_layer(dict(zip(keys, leaves)), ctx, "layers/",
                                  1, ssm_whole=ssm_whole))
        tm, tms, wkv = r6.time_mix(lp["rwkv"], L.rms_norm(lp["ln1"], h),
                                   cfg.rwkv, zero_shift, zero_wkv, tp)
        h = h + tm
        cm, cms = r6.channel_mix(lp["rwkv"], L.rms_norm(lp["ln2"], h),
                                 zero_shift, tp)
        if return_cache:
            return h + cm, tms, cms, wkv
        return h + cm

    block = T.remat_wrap(body, cfg.remat)
    per_layer = [leaf.unbind(0) for leaf in layers.values()]
    states = []
    for i in range(cfg.num_layers):
        out = block(x, *(views[i] for views in per_layer))
        if return_cache:
            x, *st = out
            states.append(st)
        else:
            x = out
    logits = T.logits_from_hidden(params, cfg, x, ctx)
    cache = None
    if return_cache:
        tms, cms, wkv = (torch.stack(s) for s in zip(*states))
        cache = {"wkv": wkv, "tm_shift": tms, "cm_shift": cms,
                 "length": torch.tensor(S, dtype=torch.int32,
                                        device=x.device)}
    return logits, torch.zeros((), dtype=torch.float32,
                               device=x.device), cache


def init_cache(cfg: ModelConfig, *, batch: int, max_seq: int,
               dtype=torch.bfloat16, device: torch.device, ctx=None
               ) -> Dict:
    """The zero state at length 0 (`max_seq` is taken for the common model
    API: the state has no sequence axis). Under the training layout `ctx`
    (see the module docstring) ``wkv`` holds this rank's heads."""
    H = r6.heads(cfg.d_model, cfg.rwkv, ssm_axis(cfg, ctx)[0])[0]
    P_ = cfg.rwkv.head_dim
    nl, D = cfg.num_layers, cfg.d_model
    return {
        "wkv": torch.zeros((nl, batch, H, P_, P_), dtype=torch.float32,
                           device=device),
        "tm_shift": torch.zeros((nl, batch, D), dtype=dtype, device=device),
        "cm_shift": torch.zeros((nl, batch, D), dtype=dtype, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def decode_step(params: Dict, cfg: ModelConfig,
                tokens: Optional[torch.Tensor], cache: Dict, *,
                embeds: Optional[torch.Tensor] = None, plan=None, ctx=None
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step on tokens (B, 1). The state leaves are updated in
    place; the returned dict carries ``length`` + 1. Returns (logits
    (B, 1, V), cache). Under the training layout (`ctx.sharded`) the rows
    are this rank's, the parameters its shards and the cache laid out as
    init_cache lays it out with `ctx`; the step runs tensor-parallel and
    gathers the logits whole, as transformer.decode_step."""
    tp, ssm_whole = ssm_axis(cfg, ctx)
    x = T.embed_lookup(params, tokens, ctx, cfg.padded_vocab_size)
    for i in range(cfg.num_layers):
        lp = T.nest(T.whole_layer(T.flatten(T.layer_slice(params["layers"],
                                                          i)),
                                  ctx, "layers/", 1, ssm_whole=ssm_whole))
        tm_out, st = r6.step_time_mix(
            lp["rwkv"], L.rms_norm(lp["ln1"], x), cfg.rwkv,
            {"wkv": cache["wkv"][i], "tm_shift": cache["tm_shift"][i]}, tp)
        x = x + tm_out
        cm_out, cms = r6.channel_mix(lp["rwkv"], L.rms_norm(lp["ln2"], x),
                                     cache["cm_shift"][i], tp)
        x = x + cm_out
        cache["wkv"][i] = st["wkv"]
        cache["tm_shift"][i] = st["tm_shift"]
        cache["cm_shift"][i] = cms
    logits = T.gather_logits(T.logits_from_hidden(params, cfg, x, ctx), cfg,
                             ctx)
    return logits, {**cache, "length": cache["length"] + 1}

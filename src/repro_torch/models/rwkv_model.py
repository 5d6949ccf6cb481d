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

Under the training layout (``forward(..., ctx=)`` with ``ctx.sharded``)
the batch is this rank's rows and the parameters its shards, gathered a
layer at a time inside the remat'd body (transformer.whole_layer).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as r6
from repro_torch.models import transformer as T


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


def _heads(cfg: ModelConfig) -> Tuple[int, int]:
    P_ = cfg.rwkv.head_dim
    return cfg.d_model // P_, P_


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
    runs)."""
    x = T.embed_lookup(params, batch["tokens"], ctx, cfg.padded_vocab_size)
    B, S, D = x.shape
    H, P_ = _heads(cfg)
    zero_shift = x.new_zeros((B, D))
    zero_wkv = x.new_zeros((B, H, P_, P_), dtype=torch.float32)
    layers = T.flatten(params["layers"])
    keys = list(layers)

    def body(h, *leaves):
        lp = T.nest(T.whole_layer(dict(zip(keys, leaves)), ctx, "layers/",
                                  1))
        tm, tms, wkv = r6.time_mix(lp["rwkv"], L.rms_norm(lp["ln1"], h),
                                   cfg.rwkv, zero_shift, zero_wkv)
        h = h + tm
        cm, cms = r6.channel_mix(lp["rwkv"], L.rms_norm(lp["ln2"], h),
                                 zero_shift)
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
               dtype=torch.bfloat16, device: torch.device) -> Dict:
    """The zero state at length 0 (`max_seq` is taken for the common model
    API: the state has no sequence axis)."""
    H, P_ = _heads(cfg)
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
                embeds: Optional[torch.Tensor] = None, plan=None
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step on tokens (B, 1). The state leaves are updated in
    place; the returned dict carries ``length`` + 1. Returns (logits
    (B, 1, V), cache)."""
    x = L.embed_tokens(params["embed"]["tok"], tokens)
    for i in range(cfg.num_layers):
        lp = T.layer_slice(params["layers"], i)
        tm_out, st = r6.step_time_mix(
            lp["rwkv"], L.rms_norm(lp["ln1"], x), cfg.rwkv,
            {"wkv": cache["wkv"][i], "tm_shift": cache["tm_shift"][i]})
        x = x + tm_out
        cm_out, cms = r6.channel_mix(lp["rwkv"], L.rms_norm(lp["ln2"], x),
                                     cache["cm_shift"][i])
        x = x + cm_out
        cache["wkv"][i] = st["wkv"]
        cache["tm_shift"][i] = st["tm_shift"]
        cache["cm_shift"][i] = cms
    logits = T.logits_from_hidden(params, cfg, x)
    return logits, {**cache, "length": cache["length"] + 1}

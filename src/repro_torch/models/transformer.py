"""Transformer: the decoder LMs (RMSNorm, RoPE, optional qk-norm and QKV
bias, GQA, a SwiGLU, squared-ReLU or GELU MLP or a mixture of such experts;
blockwise-causal Linformer attention or the standard softmax baseline), the
same decoder behind the stub vision and audio frontends
(:func:`embed_inputs`), and the paper's encoder (learned positions, GELU
MLP, exact bidirectional Linformer attention or the standard baseline).

Counterpart of ``repro/models/transformer.py``, the module of the dense,
moe, vlm and audio families (models/model.py dispatches the ssm and hybrid
families to models/rwkv_model.py and models/zamba.py, which share its
layout helpers, init, remat and LM head). Parameters are nested dicts of
tensors laid out exactly like the JAX package's pytree, in its two layer
layouts:

* scanned (``cfg.scan_layers``, the default): every leaf under ``layers``
  carries a leading layer axis, e.g. ``layers/attn/wq`` (L, d, H·Dh). Layer
  i runs on views ``a[i]`` of the stacked leaves; the forward without a
  cache, the one a backward runs through, takes them with one ``unbind``
  per leaf, so the backward stacks each leaf's gradient once instead of
  once per layer.
* unrolled (``scan_layers=False``): ``layers_list`` holds one subtree per
  layer, keyed by the layer's index as a string ("0", "1", ...), so that
  :func:`flatten` gives the JAX checkpointer's keys for its list,
  ``layers_list/{i}/attn/wq``. Only this layout gives each layer its own
  Linformer k: with ``kind="linformer"`` and per-layer E/F, layer i's E
  (and F) is (n, effective_k(k, k_decay, i, L)) (paper §4, non-uniform
  projected dimension); a layerwise-shared E keeps k.

A block with experts (``cfg.moe.num_experts > 0``) has ``moe/router`` (D,
E) in fp32 whatever the model dtype, and ``moe/w_in``, ``moe/w_gate`` and
``moe/w_out`` in place of the ``mlp`` leaves; every block returns its MoE
load-balance loss (None without experts), which :func:`forward` sums over
the layers as JAX does.

Rematerialisation (the JAX package's ``remat_wrap``): with ``cfg.remat``
"full" each block of the scanned layout runs under :class:`_Recompute`,
which keeps only the block's inputs and recomputes the block inside the
backward; the block's two outputs, the stream and the aux loss, both carry
their gradients across it. "dots" is JAX's
``dots_with_no_batch_dims_saveable``: the block runs under
``torch.utils.checkpoint`` (non-reentrant) with a selective policy that
saves the outputs of matmuls without batch dims (``aten.mm``,
``aten.addmm``: the projections by 2-D weights) and recomputes everything
else, the attention's batched einsums (``aten.bmm``), every elementwise op
and the CUDA kernels (ctypes launches the dispatcher never sees, as a
``pallas_call`` is not a dot in JAX). The unrolled
layout applies no remat, as the JAX package's unrolled loop calls
``apply_block`` directly: its activations stay alive through the backward.

Under the training layout (a ctx with ``sharded=True``, see
parallel/sharding.py) the batch holds this rank's rows over the data dims
and every parameter is this rank's shard. A layer's leaves are gathered
over their FSDP dims inside the block function (so the remat'd backward
gathers them again and a rank holds one layer's FSDP-whole shards at a
time), the final norm and head where they are used; the token embedding
looks its rows up from the shards (`sharding.sharded_lookup`). The model
dim stays sharded (`sharding.tp_keep`): tensor parallelism over the
model dim's ranks, Megatron-style. The stream between blocks is the same
on every model rank; each block's MLP (models/layers.py) and attention
(models/attention.py) multiply by their column shards and then their row
shards, and sum the partial products over the model dim; the attention
runs on this rank's heads (the plan held to them), or on whole heads
where the model width does not divide the KV heads (the whole-head route
of models/attention.py); MoE expert stacks stay on their model shard
(expert parallelism, the router replicated). The head is vocabulary-
parallel: :func:`logits_from_hidden` gives this rank's vocabulary shard
of the logits (a tied head: the embedding shard's transpose), which
models/model.py's cross-entropy reduces over the model dim; `forward`
returns that shard, and `decode_step` and `prefill_chunk` gather the
last token's logits whole. The plan's regions and the MoE layer run on
``region_ctx(ctx)``, whose data dims are excluded. With
``cfg.seq_shard_activations`` (JAX's ``_act_spec``) the stream between
blocks is this rank's sequence slice over the model dim, gathered at a
block's entry and split at its exit; the exit's sum over the model dim
and the split stand for the reduce-scatter that gloo lacks.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core import causal as causal_lib
from repro_torch.core import linformer as lin_lib
from repro_torch.core.projections import effective_k
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.parallel import comm
from repro_torch.parallel import plan as plan_lib
from repro_torch.parallel import sharding as shd
from repro_torch.tune import table as tuning

# init kinds of param_spec: constants, N(0, 0.02) embeddings, fan-in scaled
# normal weights, Linformer E/F, and the SSM leaves' other JAX inits:
# N(0, 0.1) (mamba2 conv_w, rwkv6 bonus_u) and dense_init(scale=1e-2)
# (rwkv6's low-rank mixing and decay weights)
_ONES, _ZEROS, _EMBED, _DENSE, _LIN = "ones", "zeros", "embed", "dense", "lin"
_NEG_ONES, _NORMAL_TENTH, _DENSE_SMALL = "neg_ones", "normal_0.1", "dense_0.01"
_FILL = {_ONES: 1.0, _ZEROS: 0.0, _NEG_ONES: -1.0}
_STD = {_EMBED: 0.02, _NORMAL_TENTH: 0.1, _DENSE_SMALL: 1e-2}
# init_params draws a leaf whole up to this many elements (an 8 GiB fp32
# draw), the size of every leaf of the configs ported before the larger
# dense ones, whose weights from a seed thus stay as they were; a larger
# leaf is drawn in parts along its leading axes (see init_params)
_WHOLE_DRAW_MAX = 2 ** 31


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


TRANSFORMER_FAMILIES = ("dense", "moe", "vlm", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in TRANSFORMER_FAMILIES:
        raise ValueError(
            f"config {cfg.name!r} (family {cfg.family!r}) is not a "
            f"transformer family {TRANSFORMER_FAMILIES}: build it through "
            "models/model.py, which dispatches on the family")


def _layer_lin_shapes(cfg: ModelConfig, i: int
                      ) -> Dict[str, Tuple[int, ...]]:
    """Shapes of layer i's own E/F leaves in the unrolled layout (empty for
    layerwise sharing and the standard baseline): the exact form's k
    follows effective_k, as JAX's init_block(lin_k=...)."""
    a = cfg.attention
    if a.kind == "linformer":
        lin = a.linformer
        a = dataclasses.replace(a, linformer=dataclasses.replace(
            lin, k=effective_k(lin.k, lin.k_decay, i, cfg.num_layers)))
    per = lin_lib.linformer_param_shapes(a, num_layers=1,
                                         max_seq=cfg.max_seq_len)
    return {name: shape[1:] for name, shape in per.get("per_layer",
                                                       {}).items()}


Spec = Dict[str, Tuple[Tuple[int, ...], str, torch.dtype]]


def _block_spec(cfg: ModelConfig, lin: Dict[str, Tuple[int, ...]]) -> Spec:
    """One block's {key: (shape, init kind, dtype)}, without a layer axis;
    `lin` gives its own E/F shapes."""
    a, d = cfg.attention, cfg.d_model
    H, Hkv, Dh = a.num_heads, a.num_kv_heads, a.head_dim
    dt = torch_dtype(cfg.dtype)
    spec: Spec = {
        "ln1/scale": ((d,), _ONES, dt), "ln2/scale": ((d,), _ONES, dt),
        "attn/wq": ((d, H * Dh), _DENSE, dt),
        "attn/wk": ((d, Hkv * Dh), _DENSE, dt),
        "attn/wv": ((d, Hkv * Dh), _DENSE, dt),
        "attn/wo": ((H * Dh, d), _DENSE, dt)}
    if a.qkv_bias:
        for n, w in (("bq", H), ("bk", Hkv), ("bv", Hkv)):
            spec[f"attn/{n}"] = ((w * Dh,), _ZEROS, dt)
    if a.qk_norm:
        spec["attn/q_norm/scale"] = ((Dh,), _ONES, dt)
        spec["attn/k_norm/scale"] = ((Dh,), _ONES, dt)
    for name, shape in lin.items():
        spec[f"attn/lin/{name}"] = (shape, _LIN, dt)
    if cfg.moe.num_experts > 0:
        for name, (shape, ldt) in moe_lib.moe_param_shapes(
                d, cfg.moe, cfg.mlp, dt).items():
            spec[f"moe/{name}"] = (shape, _DENSE, ldt)
        return spec
    ff = cfg.mlp.d_ff
    spec["mlp/w_in"] = ((d, ff), _DENSE, dt)
    spec["mlp/w_out"] = ((ff, d), _DENSE, dt)
    if cfg.mlp.activation == "swiglu":
        spec["mlp/w_gate"] = ((d, ff), _DENSE, dt)
    return spec


def param_spec(cfg: ModelConfig) -> Spec:
    """Flat {"/"-joined key: (shape, init kind, dtype)}, keyed exactly like
    the JAX package's checkpoints (checkpoint/checkpointer.py
    ``_flatten``). Every leaf is in the config's dtype but the MoE router,
    which is fp32 (as JAX's ``init_moe`` makes it)."""
    _check_family(cfg)
    a, d, nl = cfg.attention, cfg.d_model, cfg.num_layers
    dt = torch_dtype(cfg.dtype)
    spec: Spec = {}
    if not cfg.embedding_inputs:       # frame embeddings replace tokens
        spec["embed/tok"] = ((cfg.padded_vocab_size, d), _EMBED, dt)
    if not a.use_rope:                 # learned positions, N(0, 0.02)
        spec["embed/pos"] = ((cfg.max_seq_len, d), _EMBED, dt)
    lin = lin_lib.linformer_param_shapes(a, num_layers=nl,
                                         max_seq=cfg.max_seq_len)
    for name, shape in lin.get("shared", {}).items():
        spec[f"shared/lin/{name}"] = (shape, _LIN, dt)
    if cfg.scan_layers:
        per = {n: shape[1:] for n, shape in lin.get("per_layer", {}).items()}
        for key, (shape, kind, ldt) in _block_spec(cfg, per).items():
            spec[f"layers/{key}"] = ((nl,) + shape, kind, ldt)
    else:
        for i in range(nl):
            block = _block_spec(cfg, _layer_lin_shapes(cfg, i))
            for key, val in block.items():
                spec[f"layers_list/{i}/{key}"] = val
    spec["final_norm/scale"] = ((d,), _ONES, dt)
    if not cfg.tie_embeddings or cfg.embedding_inputs:
        spec["lm_head"] = ((d, cfg.padded_vocab_size), _DENSE, dt)
    return spec


def flatten(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{"a": {"b": {"c": x}}} -> {"a/b/c": x}, in insertion order."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = val
    return out


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    out: Dict = {}
    for key, val in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def layer_slice(tree: Dict, i: int) -> Dict:
    """Views of layer i of a stacked-layer subtree."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def layer_params(params: Dict, i: int) -> Dict:
    """Layer i's parameters in either layout: views of the stacked
    ``layers`` or the ``layers_list`` entry."""
    if "layers_list" in params:
        return params["layers_list"][str(i)]
    return layer_slice(params["layers"], i)


def _draw_parts(w: torch.Tensor):
    """The views `init_params` draws `w` in, in order: `w` whole up to
    _WHOLE_DRAW_MAX elements, else each slice along its leading axis,
    split again the same way while a slice is still larger (qwen3-moe's
    (L, E, D, ff) expert leaves go by layer, kimi-k2's by layer and
    expert). A (L, d, ff) leaf thus goes by layer, as before the expert
    leaves came."""
    if w.numel() <= _WHOLE_DRAW_MAX or w.ndim == 1:
        return [w]
    return [part for sl in w for part in _draw_parts(sl)]


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device: torch.device) -> Dict:
    """Random parameters of a transformer-family config (`init_from_spec`
    of its `param_spec`)."""
    return init_from_spec(param_spec(cfg), cfg, generator=generator,
                          device=device)


def init_from_spec(spec: Spec, cfg: ModelConfig, *,
                   generator: torch.Generator, device: torch.device) -> Dict:
    """Random parameters of `spec` with the JAX package's distributions
    (fan-in scaled normal weights, N(0, 0.02) embeddings, the constants and
    scaled normals of the SSM leaves, E/F N(0, 1/r)), drawn from
    `generator` (on `device`), each leaf in its spec dtype (the MoE router
    and the SSM decay and skip leaves in fp32). A leaf of more than
    _WHOLE_DRAW_MAX elements is drawn in parts (`_draw_parts`), so that its
    fp32 draw stays one slice (qwen1.5-110b's stacked MLP leaves would take
    35 GB at 22 layers, qwen3-moe's expert leaves 39 GB); every smaller
    leaf is drawn whole. The rule keeps each earlier config's weights from
    a seed as they were, which matters: the bf16 train-parity gate's loss
    term moves with the draw. The values differ from the JAX init: parity
    tests bridge JAX weights instead."""
    dt = torch_dtype(cfg.dtype)
    flat = {}
    for key, (shape, kind, ldt) in spec.items():
        if kind in _FILL:
            flat[key] = torch.full(shape, _FILL[kind], dtype=ldt,
                                   device=device)
        elif kind != _LIN:
            std = _STD.get(kind, shape[-2] ** -0.5 if len(shape) > 1
                           else shape[0] ** -0.5)
            w = torch.empty(shape, dtype=ldt, device=device)
            for part in _draw_parts(w):
                part.copy_(torch.randn(part.shape, generator=generator,
                                       device=device).mul_(std))
            flat[key] = w
    flat.update(lin_lib.init_linformer_params(
        generator, {key: shape for key, (shape, kind, _) in spec.items()
                    if kind == _LIN}, device=device, dtype=dt))
    return nest({key: flat[key] for key in spec})


class _Recompute(torch.autograd.Function):
    """Activation rematerialisation of `fn(*args)` (a tensor or a tuple of
    tensors and Nones out): the forward runs under no_grad and keeps only `args`; the
    backward reruns `fn` with grad enabled and differentiates each output
    that depends on `args` against its incoming gradient. Every tensor `fn`
    depends on must be among `args`: a tensor it closes over gets no
    gradient."""

    @staticmethod
    def forward(ctx, fn, *args):
        ctx.fn = fn
        ctx.save_for_backward(*args)
        return fn(*args)

    @staticmethod
    def backward(ctx, *grad_outs):
        need = ctx.needs_input_grad[1:]
        args = [a.detach().requires_grad_(n)
                for a, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            outs = ctx.fn(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        live = [(o, g) for o, g in zip(outs, grad_outs)
                if o is not None and o.requires_grad]
        wrt = [a for a, n in zip(args, need) if n]
        grads = iter(torch.autograd.grad([o for o, _ in live], wrt,
                                         [g for _, g in live],
                                         allow_unused=True))
        return (None, *(next(grads) if n else None for n in need))


# the ops whose outputs the "dots" policy saves: matmuls without batch
# dims, JAX's dots_with_no_batch_dims_saveable in aten terms
_DOTS_SAVEABLE = frozenset({torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Save a matmul without batch dims; recompute every other op (also
    ``aten.empty``, so a buffer a kernel fills out of band is refilled on
    recompute, never taken from the cache)."""
    if op in _DOTS_SAVEABLE:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn: Callable, policy: str) -> Callable:
    """`fn(*tensors)` under the remat policy whenever autograd records:
    "none" as is, "dots" under selective checkpointing (see the module
    docstring), "full" through :class:`_Recompute`."""
    if policy not in ("none", "dots", "full"):
        raise ValueError(f"unknown remat policy {policy!r}")
    if policy == "none":
        return fn
    dots_context = functools.partial(create_selective_checkpoint_contexts,
                                     _dots_policy)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if policy == "dots":
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=dots_context)
        return _Recompute.apply(fn, *args)

    return wrapped


def _ffn(params: Dict, x: torch.Tensor, cfg: ModelConfig, ctx=None,
         held_experts: bool = False, tp=None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's feed-forward on the normed stream: the MoE layer where
    the config has experts (its B·S tokens routed together, expert-parallel
    under a ctx with a model dim; `held_experts`: the expert stacks are
    this rank's model shard, see held_experts), else the MLP (tensor-
    parallel with `tp`, layers.apply_mlp). Returns (out, aux): the MoE
    load-balance loss (fp32), or None without experts."""
    if cfg.moe.num_experts > 0:
        return moe_lib.apply_moe(params["moe"], x, cfg.moe, cfg.mlp, ctx,
                                 held_experts=held_experts)
    return L.apply_mlp(params["mlp"], x, cfg.mlp, tp), None


def apply_block(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                shared_lin: Optional[Dict],
                cache_entry: Optional[Dict] = None,
                plan: plan_lib.AttentionPlan,
                chunked_attn: bool = False, ctx=None,
                held_experts: bool = False, tp=None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (x, the block's MoE aux loss, None without experts).
    `chunked_attn` selects the chunked reference form of the causal
    attention (plain route only); `held_experts` as in _ffn; `tp`: the
    model dim's Axis of tensor parallelism (see the module docstring)."""
    h = attn_lib.apply_attention(params["attn"], L.rms_norm(params["ln1"], x),
                                 cfg.attention, shared_lin=shared_lin,
                                 cache_entry=cache_entry, plan=plan,
                                 chunked=chunked_attn, tp=tp)
    x = x + h
    h, aux = _ffn(params, L.rms_norm(params["ln2"], x), cfg, ctx,
                  held_experts, tp)
    return x + h, aux


def apply_block_decode(params: Dict, x_t: torch.Tensor, layer_cache: Dict,
                       t: torch.Tensor, cfg: ModelConfig, *,
                       shared_lin: Optional[Dict],
                       plan: plan_lib.AttentionPlan, ctx=None,
                       held_experts: bool = False, tp=None
                       ) -> torch.Tensor:
    h, _ = attn_lib.apply_attention_decode(
        params["attn"], L.rms_norm(params["ln1"], x_t), layer_cache, t,
        cfg.attention, shared_lin=shared_lin, plan=plan, tp=tp)
    x_t = x_t + h
    return x_t + _ffn(params, L.rms_norm(params["ln2"], x_t), cfg, ctx,
                      held_experts, tp)[0]


def apply_block_prefill_chunk(params: Dict, x: torch.Tensor,
                              layer_cache: Dict, t0: torch.Tensor,
                              cfg: ModelConfig, *, positions: torch.Tensor,
                              shared_lin: Optional[Dict],
                              plan: plan_lib.AttentionPlan, ctx=None,
                              held_experts: bool = False, tp=None
                              ) -> torch.Tensor:
    """One transformer block over a prefill chunk at a per-row offset:
    cache-writing like `apply_block_decode`, P tokens at once."""
    h, _ = attn_lib.apply_attention_prefill_chunk(
        params["attn"], L.rms_norm(params["ln1"], x), layer_cache, t0,
        cfg.attention, shared_lin=shared_lin, positions=positions, plan=plan,
        tp=tp)
    x = x + h
    return x + _ffn(params, L.rms_norm(params["ln2"], x), cfg, ctx,
                    held_experts, tp)[0]


def whole(params: Dict, path: str, ctx=None, keep: Tuple[str, ...] = ()
          ) -> torch.Tensor:
    """The leaf at `path` of `params`, made whole under the training
    layout but for the mesh dims in `keep` (as is otherwise)."""
    node = params
    for key in path.split("/"):
        node = node[key]
    if not shd.is_sharded(ctx):
        return node
    return shd.unshard_leaf(node, shd.leaf_spec(path, node.ndim, ctx), ctx,
                            keep)


def embed_lookup(params: Dict, tokens: torch.Tensor, ctx=None,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """The token embeddings of `tokens`; under the training layout looked
    up from the table's shards (sharding.sharded_lookup; `vocab`, the
    table's whole row count, places an uneven shard)."""
    if shd.is_sharded(ctx):
        return shd.sharded_lookup(params["embed"]["tok"], tokens, ctx,
                                  vocab=vocab)
    return L.embed_tokens(params["embed"]["tok"], tokens)


def embed_inputs(params: Dict, cfg: ModelConfig, batch: Dict, ctx=None
                 ) -> torch.Tensor:
    """(B, S, D) input stream from tokens and/or stub-frontend embeddings:
    with ``embedding_inputs`` the batch's ``embeds`` (B, S, D) replace the
    tokens (audio frames); with ``frontend_embed_len`` P the batch's
    ``frontend_embeds`` (B, P, D) are prepended to the token embeddings in
    the model dtype (vision patches). A model with learned positions then
    adds the first S rows of ``embed/pos``."""
    if cfg.embedding_inputs:
        x = batch["embeds"].to(torch_dtype(cfg.dtype))
    else:
        x = embed_lookup(params, batch["tokens"], ctx,
                         cfg.padded_vocab_size)
        if cfg.frontend_embed_len > 0:
            fe = batch["frontend_embeds"].to(x.dtype)
            x = torch.cat([fe, x], dim=1)
    pos = params.get("embed", {}).get("pos")
    if pos is not None:
        pos = whole(params, "embed/pos", ctx)
        S = x.shape[1]
        if S > pos.shape[0]:
            raise ValueError(f"sequence length {S} exceeds the "
                             f"{pos.shape[0]} learned positions (the "
                             "config's max_seq_len)")
        x = x + pos[:S][None]
    return x


def head_weights(params: Dict, ctx=None):
    """(final norm scale, LM head (D, V)); a tied head is the embedding's
    transpose. Under tensor parallelism (sharding.tensor_axis) the head is
    this rank's vocabulary shard (D, V_loc), its FSDP dims gathered; else
    whole."""
    keep = (ctx.model_axis,) if shd.tensor_axis(ctx) is not None else ()
    head = whole(params, "lm_head", ctx, keep) if "lm_head" in params \
        else whole(params, "embed/tok", ctx, keep).T
    return whole(params, "final_norm/scale", ctx), head


def logits_from_hidden(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                       ctx=None) -> torch.Tensor:
    """The logits of the stream x (..., D): under tensor parallelism this
    rank's vocabulary shard (..., V_loc) (`vocab_range`; x enters through
    ``comm.copy``, so its gradient sums over the shards); else (..., V)."""
    norm, head = head_weights(params, ctx)
    tp = shd.tensor_axis(ctx)
    return comm.copy(L.rms_norm({"scale": norm}, x), (tp,)) @ head


def vocab_range(cfg: ModelConfig, ctx=None) -> Tuple[int, int]:
    """This rank's [start, stop) of the (padded) vocabulary in the logits
    that logits_from_hidden gives: its shard under tensor parallelism,
    else the whole vocabulary."""
    return shd.dim_range(cfg.padded_vocab_size, (shd.tensor_axis(ctx),))


def gather_logits(logits: torch.Tensor, cfg: ModelConfig, ctx=None
                  ) -> torch.Tensor:
    """Whole logits (..., V) from logits_from_hidden's (every model rank
    calls it; no-op without tensor parallelism): what decode samples
    from."""
    return shd.gather_dim(logits, logits.ndim - 1, shd.tensor_axis(ctx),
                          cfg.padded_vocab_size)


def init_cache(cfg: ModelConfig, *, batch: int, max_seq: int,
               dtype=torch.bfloat16, device: torch.device,
               plan: Optional[plan_lib.AttentionPlan] = None) -> Dict:
    """A zero decode cache; a compressed one is laid out per `plan`'s
    cache_pspecs (this rank's heads on a tp mesh; the standard baseline's
    full cache stays whole, its decode runs outside the plan, but under a
    plan held to this rank's heads, whose k and v it stores)."""
    spec = attn_lib.decode_cache_spec(cfg.attention,
                                      num_layers=cfg.num_layers,
                                      batch=batch, max_seq=max_seq,
                                      dtype=dtype)
    cache = {k: torch.zeros(shape, dtype=dt, device=device)
             for k, (shape, dt) in spec.items()}
    if plan is None or (cfg.attention.kind != "linformer_causal"
                        and not plan.heads_held):
        return cache
    return plan.place_cache(cache)


def _layer_caches(cache: Dict, i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in cache.items() if k != "lengths"}


def seq_dims(cfg: ModelConfig, ctx) -> Tuple:
    """The dims the stream between blocks splits its sequence over: the
    model dim under the training layout with seq_shard_activations."""
    if not (cfg.seq_shard_activations and shd.is_sharded(ctx)):
        return ()
    return (ctx.axis(ctx.model_axis),)


def held_experts(ctx) -> bool:
    """Whether a layer's MoE expert stacks stay on their model shard when
    the layer is made whole: under the training layout with expert
    parallelism (moe.apply_moe's e_offset consumes them as they are)."""
    return shd.is_sharded(ctx) and ctx.model_shards > 1


def whole_kv(cfg: ModelConfig, ctx) -> bool:
    """Whether the block takes the whole-head route of models/attention.py:
    tensor parallelism on a model width that does not divide the KV
    heads."""
    tp = shd.tensor_axis(ctx)
    return tp is not None and cfg.attention.num_kv_heads % tp.width != 0


def tp_plan(cfg: ModelConfig, plan: plan_lib.AttentionPlan, ctx
            ) -> plan_lib.AttentionPlan:
    """The plan a block takes: under tensor parallelism held to this
    rank's heads, but on the whole-head route (see whole_kv)."""
    if whole_kv(cfg, ctx):
        return plan
    return plan.held(shd.tensor_axis(ctx))


def whole_layer(lp: Dict, ctx, prefix: str, drop: int = 0,
                kv_whole: bool = False, ssm_whole: bool = False) -> Dict:
    """A layer's leaves (flat or nested, keyed below `prefix` in the
    parameter tree; `drop` = 1 for views of layer-stacked leaves) gathered
    over their FSDP dims under the training layout; the model dim stays
    on this rank's shard (sharding.tp_keep; `kv_whole`: the whole-head
    route's KV projections are gathered whole, `ssm_whole`: the Mamba2 or
    RWKV6 leaves of the gathered route)."""
    if not shd.is_sharded(ctx):
        return lp
    return shd.unshard_tree(
        lp, ctx, prefix, drop,
        lambda path: shd.tp_keep(path, ctx, kv_whole, ssm_whole))


def _block_fn(cfg: ModelConfig, plan: plan_lib.AttentionPlan, keys,
              shared_keys, chunked_attn: bool = False, ctx=None,
              prefix: str = "layers/", drop: int = 1,
              cache_entry: Optional[Dict] = None) -> Callable:
    """apply_block as a function of tensors alone, (x, *layer leaves,
    *shared E/F leaves) -> (x, aux or None), so that remat sees every
    tensor it depends on. Under the training layout the leaves arrive as
    shards and are gathered over their FSDP dims here, and the block runs
    tensor-parallel (see the module docstring)."""
    n = len(keys)
    seq = seq_dims(cfg, ctx)
    rctx, held = shd.region_ctx(ctx), held_experts(ctx)
    tp, kv = shd.tensor_axis(ctx), whole_kv(cfg, ctx)
    plan = tp_plan(cfg, plan, ctx)

    def fn(x, *leaves):
        shared = dict(zip(shared_keys, leaves[n:])) or None
        lp = whole_layer(dict(zip(keys, leaves[:n])), ctx, prefix, drop, kv)
        x, aux = apply_block(nest(lp), comm.gather(x, 1, seq), cfg,
                             shared_lin=shared, cache_entry=cache_entry,
                             plan=plan, chunked_attn=chunked_attn, ctx=rctx,
                             held_experts=held, tp=tp)
        return comm.split(x, 1, seq), aux

    return fn


def forward(params: Dict, cfg: ModelConfig, batch: Dict, *,
            return_cache: bool = False, cache_max_seq: Optional[int] = None,
            cache_dtype=torch.bfloat16, return_hidden: bool = False,
            plan: Optional[plan_lib.AttentionPlan] = None, ctx=None
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """Full-sequence forward. Returns (logits (B, S, V), aux, cache|None);
    with return_hidden, the final hidden states (B, S, D) before the final
    norm instead of the logits. Under tensor parallelism the logits are
    this rank's vocabulary shard (B, S, V_loc) (`vocab_range`) and the
    cache this rank's KV heads.

    With return_cache=True the sequence length must be a multiple of the
    Linformer block size (standard attention: any length); the cache is
    built in the same pass (the config's single_pass_cache) and positioned
    at t = S, ready for decode_step. When autograd records, each block of
    the scanned layout runs under the config's remat policy; the unrolled
    layout runs its blocks as they are (no remat, as in JAX). `aux` is the
    fp32 sum over layers of the blocks' MoE load-balance losses (zero
    without experts). `ctx` (parallel/sharding.ParallelCtx): without a
    `plan`, the attention plan is resolved on it; the MoE layers run
    expert-parallel on its model dim."""
    if return_cache and not cfg.single_pass_cache:
        raise ValueError("only the single-pass prefill cache is ported")
    plan = plan if plan is not None else plan_lib.resolve_attention_plan(
        cfg.attention, shd.region_ctx(ctx))
    x = embed_inputs(params, cfg, batch, ctx)
    B, S, _ = x.shape
    chunked = S >= causal_lib.chunked_attention_min_seq(
        tuning.platform_key(x.device))
    shared_lin = _shared_lin(params, ctx)
    cache = None
    if return_cache:
        cache = init_cache(cfg, batch=B,
                           max_seq=cache_max_seq or cfg.max_seq_len,
                           dtype=cache_dtype, device=x.device,
                           plan=tp_plan(cfg, plan, ctx))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    seq = seq_dims(cfg, ctx)
    x = comm.split(x, 1, seq)
    shared = shared_lin or {}
    if cache is not None or not cfg.scan_layers:
        for i in range(cfg.num_layers):
            lp = flatten(layer_params(params, i))
            prefix, drop = ((f"layers_list/{i}/", 0) if "layers_list"
                            in params else ("layers/", 1))
            fn = _block_fn(cfg, plan, list(lp), list(shared), chunked, ctx,
                           prefix, drop, None if cache is None
                           else _layer_caches(cache, i))
            x, a = fn(x, *lp.values(), *shared.values())
            aux = aux if a is None else aux + a
    else:
        layers = flatten(params["layers"])
        per_layer = [leaf.unbind(0) for leaf in layers.values()]
        block = remat_wrap(_block_fn(cfg, plan, list(layers), list(shared),
                                     chunked, ctx), cfg.remat)
        for i in range(cfg.num_layers):
            x, a = block(x, *(views[i] for views in per_layer),
                         *shared.values())
            aux = aux if a is None else aux + a
    x = comm.gather(x, 1, seq)
    logits = x if return_hidden else logits_from_hidden(params, cfg, x, ctx)
    if cache is not None:
        cache["lengths"].fill_(S)
    return logits, aux, cache


def _layer_views(params: Dict, ctx, i: int, kv: bool) -> Dict:
    """Layer i's parameters as a block takes them: gathered over their
    FSDP dims under the training layout (whole_layer), as is otherwise."""
    lp = layer_params(params, i)
    if not shd.is_sharded(ctx):
        return lp
    prefix, drop = ((f"layers_list/{i}/", 0) if "layers_list" in params
                    else ("layers/", 1))
    return nest(whole_layer(flatten(lp), ctx, prefix, drop, kv))


def _shared_lin(params: Dict, ctx) -> Optional[Dict]:
    shared_lin = params.get("shared", {}).get("lin")
    if shared_lin is not None and shd.is_sharded(ctx):
        shared_lin = shd.unshard_tree(shared_lin, ctx, "shared/lin/")
    return shared_lin


def decode_step(params: Dict, cfg: ModelConfig,
                tokens: Optional[torch.Tensor], cache: Dict, *,
                embeds: Optional[torch.Tensor] = None,
                plan: Optional[plan_lib.AttentionPlan] = None, ctx=None
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens: (B, 1); with ``embedding_inputs`` the step
    takes ``embeds`` (B, 1, D) instead (tokens may be None). Row b decodes
    at cache["lengths"][b]. Returns (logits (B, 1, V), cache): the cache
    leaves are updated in place; the returned dict carries a new
    ``lengths`` = old + 1. Under the training layout (`ctx.sharded`) the
    rows are this rank's, the parameters its shards and the cache its KV
    heads (init_cache with the plan tp_plan gives); the step runs
    tensor-parallel and gathers the logits whole, so that sampling is
    unchanged."""
    plan = plan if plan is not None \
        else plan_lib.resolve_attention_plan(cfg.attention,
                                             shd.region_ctx(ctx))
    plan = tp_plan(cfg, plan, ctx)
    tp, kv, rctx = shd.tensor_axis(ctx), whole_kv(cfg, ctx), \
        shd.region_ctx(ctx)
    t = cache["lengths"]
    if cfg.embedding_inputs:
        if embeds is None:
            raise ValueError(f"config {cfg.name!r} decodes from embeds "
                             "(B, 1, D), not tokens")
        x = embeds.to(torch_dtype(cfg.dtype))
    else:
        x = embed_lookup(params, tokens, ctx, cfg.padded_vocab_size)
    if "pos" in params.get("embed", {}):
        x = x + whole(params, "embed/pos", ctx)[t.long()][:, None]
    shared_lin = _shared_lin(params, ctx)
    for i in range(cfg.num_layers):
        x = apply_block_decode(_layer_views(params, ctx, i, kv), x,
                               _layer_caches(cache, i), t, cfg,
                               shared_lin=shared_lin, plan=plan, ctx=rctx,
                               held_experts=held_experts(ctx), tp=tp)
    logits = gather_logits(logits_from_hidden(params, cfg, x, ctx), cfg,
                           ctx)
    return logits, {**cache, "lengths": t + 1}


def prefill_chunk(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: Dict, n_valid: torch.Tensor, *,
                  plan: Optional[plan_lib.AttentionPlan] = None, ctx=None
                  ) -> Tuple[torch.Tensor, Dict]:
    """Prefill-at-offset forward of one fixed-size chunk of every row.

    tokens (B, P): row b's next prefill chunk, padded at the END to the
    chunk width P; n_valid (B,) counts its real tokens (a multiple of the
    block size, so padding fills whole blocks and needs no mask). Row b's
    chunk starts at its committed length cache["lengths"][b]: rope runs at
    the absolute positions and each layer's K/V state is written at the
    row's offset, in place. Returns (logits at each row's last real token
    (B, V), cache with ``lengths`` advanced by n_valid). Under the
    training layout as decode_step."""
    if cfg.embedding_inputs or cfg.frontend_embed_len > 0:
        raise ValueError("chunked prefill supports token inputs only")
    plan = plan if plan is not None \
        else plan_lib.resolve_attention_plan(cfg.attention,
                                             shd.region_ctx(ctx))
    plan = tp_plan(cfg, plan, ctx)
    tp, kv, rctx = shd.tensor_axis(ctx), whole_kv(cfg, ctx), \
        shd.region_ctx(ctx)
    t0 = cache["lengths"]
    B, P = tokens.shape
    n_valid = torch.as_tensor(n_valid, device=tokens.device).to(t0.dtype)
    x = embed_lookup(params, tokens, ctx, cfg.padded_vocab_size)
    positions = t0[:, None] + torch.arange(P, device=x.device)[None, :]
    if "pos" in params["embed"]:
        tab = whole(params, "embed/pos", ctx)
        x = x + tab[positions.clamp(0, tab.shape[0] - 1).long()]
    shared_lin = _shared_lin(params, ctx)
    for i in range(cfg.num_layers):
        x = apply_block_prefill_chunk(
            _layer_views(params, ctx, i, kv), x, _layer_caches(cache, i),
            t0, cfg, positions=positions, shared_lin=shared_lin, plan=plan,
            ctx=rctx, held_experts=held_experts(ctx), tp=tp)
    last = (n_valid - 1).long()[:, None, None].expand(B, 1, x.shape[-1])
    logits = gather_logits(
        logits_from_hidden(params, cfg, x.gather(1, last), ctx), cfg, ctx)
    return logits[:, 0], {**cache, "lengths": t0 + n_valid}


def param_bytes(params: Dict) -> int:
    total = 0
    stack = [params]
    while stack:
        node = stack.pop()
        for v in node.values():
            if isinstance(v, dict):
                stack.append(v)
            else:
                total += v.numel() * v.element_size()
    return total


def cache_nbytes(spec: Dict) -> int:
    return sum(math.prod(shape) * torch.empty((), dtype=dt).element_size()
               for shape, dt in spec.values())

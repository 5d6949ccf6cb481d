"""Attention block: QKV/output projections and dispatch between the paper's
softmax baseline (``kind="standard"``: full attention, full KV cache) and
its Linformer forms: the exact bidirectional form (``kind="linformer"``,
encoder training and inference) and the blockwise-causal form
(``kind="linformer_causal"``: prefill, chunked prefill and decode, over the
compressed cache or its paged, quantized sibling).

Counterpart of ``repro/models/attention.py``. The Linformer math dispatches
through an :class:`AttentionPlan` (parallel/plan.py); this module never
branches on backend strings. The standard baseline is plain torch, as the
JAX package's is plain jnp: it materialises the (S, S) scores, which is
the cost the paper's Table 3 measures. Per-layer E/F (every sharing mode
but layerwise) live under the layer's ``lin`` leaves, laid out by
models/transformer.py ``param_spec``; the layerwise E arrives as
`shared_lin`. The exact form has no decode cache: its decode and
chunked-prefill entry points raise, as in the JAX package.

Tensor parallelism (the entry points' `tp`, the model dim's Axis under the
training layout, parallel/sharding.tensor_axis): the projections are this
rank's shards of JAX's ``P(None, F, "model")`` / ``P(None, "model", F)``
specs, Megatron-style. ``wq``/``wk``/``wv`` (and qwen1.5's ``b[qkv]``) are
column-parallel, so q, k and v are this rank's heads, and the plan, held
to those heads (``AttentionPlan.held``), attends them and returns them;
``wo`` is row-parallel, its partial products summed over the model dim
(``comm.reduce``). The rule for a model width that does not divide
``num_kv_heads`` (SMOKE's Hkv = 2 at tp 4, qwen3-8b's Hkv = 8 on a
16-wide model dim), where the plan cannot split the KV heads (JAX's
warning, launch/mesh.validate_attention_mesh): the whole-head route.
``wk``/``wv``/``bk``/``bv`` are then gathered whole
(sharding.tp_keep), q's column shard is gathered over the model dim into
whole heads (``comm.gather``), every model rank attends every head, and
the attention output is split back to this rank's columns
(``comm.split``) for the row-parallel ``wo``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.core import cache as cache_lib
from repro_torch.core import causal as causal_lib
from repro_torch.core import linformer as lin_lib
from repro_torch.models import layers as L
from repro_torch.parallel import comm
from repro_torch.parallel import plan as plan_lib


def _check_cached(cfg: AttentionConfig, what: str) -> None:
    """The decode cache paths exist for the causal form and the standard
    baseline (the exact form is bidirectional: encoder-only)."""
    lin_lib.check_kind(cfg)
    if cfg.kind == "linformer":
        raise ValueError(
            f"attention kind {cfg.kind!r} has no {what} path "
            "(exact linformer is bidirectional/encoder-only)")


def project_qkv(params: Dict, x: torch.Tensor, cfg: AttentionConfig,
                positions: Optional[torch.Tensor], tp=None,
                local_heads: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The heads of x (B, S, D) as the attention sees them: q (B, S, H, Dh),
    k and v (B, S, Hkv, Dh), biases, qk-norm and rope (at `positions`, or
    0..S-1) applied (the JAX package's ``_qkv``). With `tp` (see the
    module docstring) the heads are this rank's where `local_heads`, and
    whole (q gathered, k and v from whole weights) where not."""
    B, S, _ = x.shape
    Dh = cfg.head_dim
    xp = comm.copy(x, (tp,))
    q = xp @ params["wq"]
    kv_in = xp if local_heads else x
    k = kv_in @ params["wk"]
    v = kv_in @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if not local_heads:
        q = comm.gather(q, 2, (tp,))
    q = q.reshape(B, S, -1, Dh)
    k = k.reshape(B, S, -1, Dh)
    v = v.reshape(B, S, -1, Dh)
    if cfg.qk_norm:
        # one scale for every head: on this rank's heads its gradient is
        # a part, summed over the model dim
        tp_heads = (tp,) if local_heads else ()
        q = L.rms_norm({"scale": comm.copy(params["q_norm"]["scale"],
                                           tp_heads)}, q)
        k = L.rms_norm({"scale": comm.copy(params["k_norm"]["scale"],
                                           tp_heads)}, k)
    if cfg.use_rope:
        pos = positions if positions is not None \
            else torch.arange(S, device=x.device)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def project_out(params: Dict, out: torch.Tensor, tp=None,
                local_heads: bool = False) -> torch.Tensor:
    """The output projection of the attention's heads `out` (..., H·Dh):
    with `tp`, row-parallel over this rank's heads (whole heads are split
    to this rank's columns first), summed over the model dim."""
    if not local_heads:
        out = comm.split(out, out.ndim - 1, (tp,))
    return comm.reduce(out @ params["wo"], (tp,))


def _resolve_ef(params: Dict, shared_lin: Optional[Dict],
                cfg: AttentionConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E, F) of one layer. Layerwise sharing uses the one E for K and V."""
    if cfg.linformer.sharing == "layerwise":
        if shared_lin is None:
            raise ValueError("layerwise sharing needs the shared E")
        E = shared_lin["E"]
        return E, E
    lp = params["lin"]
    return lp["E"], lp.get("F", lp["E"])


def standard_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool, scale: Optional[float] = None
                       ) -> torch.Tensor:
    """Full softmax attention (the paper's baseline), GQA-grouped, with the
    JAX function's cast points (core/causal.masked_softmax): the score
    einsum in the input dtype, then fp32; softmax in fp32; p cast to q's
    dtype before the value product. q: (B, S, H, Dh); k, v: (B, S, Hkv,
    Dh). Returns (B, S, H, Dh)."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    scale_ = scale if scale is not None else Dh ** -0.5
    qg = q.reshape(B, S, Hkv, H // Hkv, Dh)
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device).tril_() \
        if causal else None
    # the fp32 scores are freed inside masked_softmax, before the value
    # product: two (B, H, S, S) fp32 buffers fewer at the peak than JAX's
    # new arrays, the same values
    p = causal_lib.masked_softmax(
        torch.einsum("bshgd,bthd->bhgst", qg, k), ok, scale_, q.dtype)
    return torch.einsum("bhgst,bthd->bshgd", p, v).reshape(B, S, H, Dh)


def apply_attention(
    params: Dict,
    x: torch.Tensor,
    cfg: AttentionConfig,
    *,
    shared_lin: Optional[Dict] = None,
    positions: Optional[torch.Tensor] = None,
    cache_entry: Optional[Dict[str, torch.Tensor]] = None,
    plan: Optional[plan_lib.AttentionPlan] = None,
    chunked: bool = False,
    tp=None,
) -> torch.Tensor:
    """Full-sequence attention (training / prefill). x: (B, S, D).

    With `cache_entry` — this layer's slices of a decode cache — also fills
    the cache from the SAME k/v (single-pass prefill, no second forward);
    the causal form and the standard baseline. `chunked` picks the
    memory-bounded chunked form of the causal attention's plain route
    (AttentionPlan.causal_attention). `tp`: tensor parallelism (see the
    module docstring); the heads are this rank's where `plan` is held to
    them."""
    lin_lib.check_kind(cfg)
    if cache_entry is not None and cfg.kind == "linformer":
        raise ValueError(f"no decode cache for attention kind {cfg.kind!r}")
    B, S, _ = x.shape
    plan = plan if plan is not None else plan_lib.resolve_attention_plan(cfg)
    held = plan.heads_held
    q, k, v = project_qkv(params, x, cfg, positions, tp, held)
    ef = None
    if cfg.kind == "standard":
        out = standard_attention(q, k, v, causal=cfg.causal)
    elif cfg.kind == "linformer":
        E, F = _resolve_ef(params, shared_lin, cfg)
        out = plan.exact_attention(q, k, v, E, F,
                                   projection=cfg.linformer.projection,
                                   scale=cfg.head_dim ** -0.5)
    else:
        ef = _resolve_ef(params, shared_lin, cfg)
        out = plan.causal_attention(q, k, v, *ef,
                                    block_size=cfg.linformer.block_size,
                                    block_slots=cfg.linformer.block_slots,
                                    scale=cfg.head_dim ** -0.5,
                                    chunked=chunked)
    out = project_out(params, out.reshape(B, S, -1), tp, held)
    if cache_entry is not None:
        _entry_from_kv(k, v, cfg, ef, cache_entry, plan)
    return out


def _entry_from_kv(k, v, cfg: AttentionConfig, ef,
                   entry: Dict[str, torch.Tensor], plan=None) -> None:
    """Fill one layer's zero-initialized decode-cache slices from prefilled
    k/v (rope applied). Compressed cache (comp_k (B, M, Hkv, Dh), ...): the
    first nb·r slots take the compressed blocks; the ring stays empty at
    t = S. Full cache (k (B, max_seq, Hkv, Dh), ...): the first S positions
    take k/v, the rest stays zero (JAX's padded entry). The compressed
    cache of a plan that lays its pool out over tp (cache_pspecs) takes
    this rank's heads."""
    if cfg.kind != "standard" and plan is not None:
        k, v, *ef = cache_lib.local_kv(plan, entry["comp_k"].shape[2], k, v,
                                       *ef)
    B, S, Hkv, Dh = k.shape
    if cfg.kind == "standard":
        cap = entry["k"].shape[1]
        if S > cap:
            raise ValueError(f"prefill of {S} tokens exceeds the full "
                             f"cache's {cap} positions")
        entry["k"][:, :S] = k.to(entry["k"].dtype)
        entry["v"][:, :S] = v.to(entry["v"].dtype)
        return
    E, F = ef
    c = cfg.linformer.block_size
    r = cfg.linformer.block_slots
    if S % c != 0:
        raise ValueError(f"prefill length {S} not a multiple of block {c}")
    nb = S // c
    M = entry["comp_k"].shape[1]
    if nb * r > M:
        raise ValueError(f"prefill of {S} tokens needs {nb * r} compressed "
                         f"slots, the cache holds {M}")
    for name, x, W in (("comp_k", k, E), ("comp_v", v, F)):
        comp = causal_lib.compress_blocks(x.reshape(B, nb, c, Hkv, Dh), W)
        entry[name][:, :nb * r] = comp.reshape(B, nb * r, Hkv, Dh)


def apply_attention_decode(
    params: Dict,
    x_t: torch.Tensor,                 # (B, 1, D)
    layer_cache: Dict[str, torch.Tensor],
    t: torch.Tensor,                   # (B,) int32 current positions
    cfg: AttentionConfig,
    *,
    shared_lin: Optional[Dict] = None,
    plan: Optional[plan_lib.AttentionPlan] = None,
    tp=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode step against the layer's cache (updated in place).
    Each row decodes at its own position t[b]: rope, cache write and mask
    are all per row. `tp` as in apply_attention."""
    _check_cached(cfg, "decode")
    plan = plan if plan is not None else plan_lib.resolve_attention_plan(cfg)
    held = plan.heads_held
    positions = t[:, None]                                   # (B, 1)
    q, k, v = project_qkv(params, x_t, cfg, positions, tp, held)
    B = x_t.shape[0]
    if cfg.kind == "standard":
        out, new_cache = cache_lib.full_decode_attention(q, k, v,
                                                         layer_cache, t)
        return project_out(params, out.reshape(B, 1, -1), tp,
                           held), new_cache
    E, F = _resolve_ef(params, shared_lin, cfg)
    # the paged, quantized cache routes on its page_table leaf: the same
    # attention math over another storage
    decode_fn = (cache_lib.paged_decode_attention
                 if "page_table" in layer_cache
                 else cache_lib.compressed_decode_attention)
    out, new_cache = decode_fn(q, k, v, layer_cache, E, F, t, plan=plan)
    return project_out(params, out.reshape(B, 1, -1), tp, held), new_cache


def apply_attention_prefill_chunk(
    params: Dict,
    x: torch.Tensor,                   # (B, P, D) — one prefill chunk
    layer_cache: Dict[str, torch.Tensor],
    t0: torch.Tensor,                  # (B,) int32 — row's committed length
    cfg: AttentionConfig,
    *,
    shared_lin: Optional[Dict] = None,
    positions: Optional[torch.Tensor] = None,   # (B, P) absolute positions
    plan: Optional[plan_lib.AttentionPlan] = None,
    tp=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunked-prefill attention at a per-row offset against the layer's
    slot-resident cache (updated in place): row b's chunk covers absolute
    positions [t0[b], t0[b] + P); t0 and P are multiples of the block
    size (standard attention takes any offset). Returns (out (B, P, D'),
    the cache). `tp` as in apply_attention."""
    _check_cached(cfg, "chunked-prefill")
    plan = plan if plan is not None else plan_lib.resolve_attention_plan(cfg)
    held = plan.heads_held
    if positions is None:
        positions = t0[:, None] + torch.arange(x.shape[1], device=x.device)
    q, k, v = project_qkv(params, x, cfg, positions, tp, held)
    B, P = x.shape[:2]
    if cfg.kind == "standard":
        out, new_cache = cache_lib.full_prefill_chunk(q, k, v, layer_cache,
                                                      t0)
        return project_out(params, out.reshape(B, P, -1), tp,
                           held), new_cache
    E, F = _resolve_ef(params, shared_lin, cfg)
    prefill_fn = (cache_lib.paged_prefill_chunk
                  if "page_table" in layer_cache
                  else cache_lib.compressed_prefill_chunk)
    out, new_cache = prefill_fn(q, k, v, layer_cache, E, F, t0, plan=plan)
    return project_out(params, out.reshape(B, P, -1), tp, held), new_cache


def decode_cache_spec(cfg: AttentionConfig, *, num_layers: int, batch: int,
                      max_seq: int, dtype=torch.bfloat16):
    """{leaf: (shape, dtype)} of this attention kind's decode cache: the
    compressed cache for the causal form, the full cache for the standard
    baseline."""
    lin_lib.check_kind(cfg)
    if cfg.kind == "linformer":
        raise ValueError(f"no decode cache for attention kind {cfg.kind!r}")
    if cfg.kind == "standard":
        return cache_lib.full_cache_spec(
            num_layers=num_layers, batch=batch, max_seq=max_seq,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            dtype=dtype)
    return cache_lib.compressed_cache_spec(
        num_layers=num_layers, batch=batch, max_seq=max_seq,
        block_size=cfg.linformer.block_size,
        block_slots=cfg.linformer.block_slots,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, dtype=dtype)


def paged_decode_cache_spec(cfg: AttentionConfig, *, num_layers: int,
                            batch: int, max_seq: int,
                            arena_pages: Optional[int] = None,
                            page_dtype: str = "int8"):
    """{leaf: (shape, dtype)} of the paged, quantized decode cache (the
    linformer_causal serving pool in int8/fp8 page storage)."""
    if cfg.kind != "linformer_causal":
        raise ValueError(
            f"paged cache requires kind='linformer_causal', got {cfg.kind!r}")
    return cache_lib.paged_cache_spec(
        num_layers=num_layers, batch=batch, max_seq=max_seq,
        block_size=cfg.linformer.block_size,
        block_slots=cfg.linformer.block_slots,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        arena_pages=arena_pages, page_dtype=page_dtype)

"""Unified model API and the device-resident decode loop.

Counterpart of ``repro/models/model.py``: dispatches on ``cfg.family`` (the
transformer families dense, moe, vlm and audio to models/transformer.py,
hybrid to models/zamba.py, ssm to models/rwkv_model.py) for params,
forward and decode, and provides the training losses. Entry points take an
explicit device; randomness comes from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import rwkv_model, transformer, zamba
from repro_torch.parallel import comm
from repro_torch.parallel import plan as plan_lib
from repro_torch.parallel import sharding as shd

TRANSFORMER_FAMILIES = transformer.TRANSFORMER_FAMILIES


def _impl(cfg: ModelConfig):
    """The family's module."""
    if cfg.family in TRANSFORMER_FAMILIES:
        return transformer
    if cfg.family == "hybrid":
        return zamba
    if cfg.family == "ssm":
        return rwkv_model
    raise ValueError(f"unknown family {cfg.family!r}")


def param_spec(cfg: ModelConfig) -> transformer.Spec:
    """Flat {key: (shape, init kind, dtype)} of the config's parameters,
    keyed as the JAX checkpointer's."""
    return _impl(cfg).param_spec(cfg)


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> Dict:
    """Random parameters drawn from a torch.Generator seeded with `seed`,
    on `device` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _impl(cfg).init_params(cfg, generator=gen, device=dev)


def forward(params, cfg: ModelConfig, batch: Dict, *, ctx=None, **kw):
    """Full-sequence forward; see transformer.forward. `ctx`
    (parallel/sharding.ParallelCtx) puts the attention and MoE layers on
    its mesh; with ``ctx.sharded`` the batch is this rank's rows and the
    parameters its shards (the training layout)."""
    return _impl(cfg).forward(params, cfg, batch, ctx=ctx, **kw)


def init_cache(cfg: ModelConfig, *, batch: int, max_seq: int,
               dtype=torch.bfloat16,
               device: Union[str, torch.device] = "cuda",
               plan: Optional[plan_lib.AttentionPlan] = None,
               ctx=None) -> Dict:
    """A zero decode cache; a compressed attention cache (transformer and
    hybrid families) is laid out per `plan`'s cache_pspecs (this rank's
    heads on a tp mesh); the ssm and hybrid families' recurrent states
    per `ctx` (under the training layout this rank's Mamba2 or RWKV6
    heads, JAX's cache spec)."""
    impl = _impl(cfg)
    kw = {"plan": plan} if impl is not rwkv_model else {}
    if impl is not transformer:
        kw["ctx"] = ctx
    return impl.init_cache(cfg, batch=batch, max_seq=max_seq, dtype=dtype,
                           device=resolve_device(device), **kw)


def decode_step(params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
                cache: Dict, *, embeds: Optional[torch.Tensor] = None,
                plan: Optional[plan_lib.AttentionPlan] = None, ctx=None):
    """One decode step on tokens (B, 1), or on ``embeds`` (B, 1, D) for a
    config with ``embedding_inputs``; see transformer.decode_step (and the
    ssm and hybrid modules' own, whose rows share one scalar length)."""
    return _impl(cfg).decode_step(params, cfg, tokens, cache, embeds=embeds,
                                  plan=plan, ctx=ctx)


def prefill_chunk(params, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: Dict, n_valid, *,
                  plan: Optional[plan_lib.AttentionPlan] = None, ctx=None):
    """Prefill-at-offset forward of one fixed-size chunk per row (serving's
    chunked-admission path); see transformer.prefill_chunk. Transformer
    families only: ssm/hybrid caches have no per-row positions to chunk
    against."""
    impl = _impl(cfg)
    if not hasattr(impl, "prefill_chunk"):
        raise ValueError(
            f"family {cfg.family!r} has no chunked-prefill path")
    return impl.prefill_chunk(params, cfg, tokens, cache, n_valid,
                              plan=plan, ctx=ctx)


def sample(logits: torch.Tensor, temperature: float = 0.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Next tokens from (..., V) logits: argmax at temperature 0, else a
    draw from softmax(logits / T) by the Gumbel-max trick, the method
    `jax.random.categorical` uses: argmax(logits / T - log(-log u)) with u
    uniform from `generator`, which must live on the logits' device. No
    host sync."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError(f"temperature={temperature} sampling needs an "
                         "explicit torch.Generator")
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.to(torch.float32) / temperature + gumbel,
                        dim=-1)


def decode_scan(
    params,
    cfg: ModelConfig,
    cur: torch.Tensor,        # (B,) int — first un-emitted sampled token
    finished: torch.Tensor,   # (B,) bool — rows whose output is frozen to eos
    cache: Dict,
    *,
    n_steps: int,
    eos_id: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    plan: Optional[plan_lib.AttentionPlan] = None,
    ctx=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, Dict]:
    """Device-resident multi-token decode: `n_steps` decode steps with
    on-device sampling (`sample`: argmax at temperature 0, Gumbel-max from
    `generator` above it) and on-device EOS masking. Nothing here waits for
    the device: the caller syncs ONCE per chunk on the returned tensors.

    Each step emits `cur` (frozen to eos_id for finished rows), feeds it back
    through `decode_step`, and samples the next token. Finished rows freeze
    their position counter (cache["lengths"]), so an idle slot of a pool
    never advances past the cache capacity; an ssm/hybrid cache keeps one
    scalar ``length`` for every row, which advances. A per-row `bad` flag latches
    when a still-live row's logits go non-finite.
    Returns (tokens (B, n_steps), next cur, finished, bad, cache)."""
    plan = plan if plan is not None \
        else plan_lib.resolve_attention_plan(cfg.attention,
                                             shd.region_ctx(ctx))
    bad = torch.zeros_like(finished)
    toks = []
    for _ in range(n_steps):
        tok = torch.where(finished, torch.full_like(cur, eos_id), cur)
        finished = finished | (tok == eos_id)
        prev_lengths = cache.get("lengths")
        logits, cache = decode_step(params, cfg, tok[:, None], cache,
                                    plan=plan, ctx=ctx)
        if prev_lengths is not None:    # ssm/hybrid caches keep a scalar
            cache["lengths"] = torch.where(finished, prev_lengths,
                                           cache["lengths"])
        last = logits[:, 0]
        bad = bad | (~torch.isfinite(last).all(dim=-1) & ~finished)
        cur = sample(last, temperature, generator).to(cur.dtype)
        toks.append(tok)
    return torch.stack(toks, dim=1), cur, finished, bad, cache


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, *, vocab_start: int = 0, tp=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable CE in fp32. labels: (B, S) int; mask: (B, S) {0, 1} loss
    weights. Returns (sum_loss, sum_weight).

    Vocabulary-parallel with `tp` (the model dim's Axis,
    parallel/sharding.tensor_axis): `logits` are this rank's shard of the
    vocabulary, from column `vocab_start` (transformer.vocab_range). Each
    row's max over the shards comes from ``comm.amax``; the sums of exp
    and the label's logit, taken on the shard that holds it, are summed
    over the model dim with ``comm.reduce`` (identity backward: each
    rank's gradient lands on its own columns). The loss and its gradient
    are the whole head's, and no rank holds (tokens × V) logits."""
    logits = logits.to(torch.float32)
    if comm.flat_width((tp,)) == 1:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        nll = (lse - ll) * mask
        return nll.sum(), mask.sum()
    n = logits.shape[-1]
    m = logits.amax(-1) if n else \
        logits.new_full(logits.shape[:-1], float("-inf"))
    m = comm.amax(m, (tp,))
    z = comm.reduce(torch.exp(logits - m[..., None]).sum(-1), (tp,))
    local = labels.long() - vocab_start
    hit = (local >= 0) & (local < n)
    ll = torch.gather(logits, -1, local.clamp(0, max(n - 1, 0))[..., None]
                      )[..., 0] if n else torch.zeros_like(m)
    ll = comm.reduce(torch.where(hit, ll, torch.zeros_like(ll)), (tp,))
    nll = (torch.log(z) + m - ll) * mask
    return nll.sum(), mask.sum()


def chunked_head_ce(params, cfg: ModelConfig, hidden: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor, *,
                    chunk: int, ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """LM-head matmul + CE over sequence chunks: the (B, S, V) logits tensor
    is never materialised; the backward recomputes each chunk's logits
    (transformer.remat_wrap, "full"). Vocabulary-parallel under tensor
    parallelism (cross_entropy)."""
    B, S, D = hidden.shape
    if S % chunk != 0:
        chunk = S
    norm, head = transformer.head_weights(params, ctx)
    tp = shd.tensor_axis(ctx)
    lo = transformer.vocab_range(cfg, ctx)[0]

    def body(h_c, y_c, m_c, norm_, head_):
        x = comm.copy(L.rms_norm({"scale": norm_}, h_c), (tp,))
        return cross_entropy(x @ head_, y_c, m_c, vocab_start=lo, tp=tp)[0]

    body = transformer.remat_wrap(body, "full")
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, chunk):
        sl = slice(i, i + chunk)
        nll = nll + body(hidden[:, sl], labels[:, sl], mask[:, sl], norm,
                         head)
    return nll, mask.sum()


def loss_fn(params, cfg: ModelConfig, batch: Dict, *,
            plan: Optional[plan_lib.AttentionPlan] = None, ctx=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens (B, S) or, with ``embedding_inputs``, embeds
    (B, S, D); with ``frontend_embed_len`` P also frontend_embeds (B, P, D);
    labels (B, S) and loss_mask (B, S) over the text positions. Causal LM:
    labels are the inputs shifted by one (built by the data pipeline). The
    first P positions of the output (the frontend's) take no loss.
    Returns (total, metrics): the total is the mean CE, plus
    ``moe.aux_loss_weight`` times the MoE load-balance loss summed over
    the layers where the config has experts; metrics are the CE alone
    (loss), that raw sum (aux_loss), tokens and perplexity, as JAX reports
    them.

    Under the training layout (``ctx.sharded``) the batch is this rank's
    rows: the CE's numerator and denominator are summed over the data dims
    (``comm.reduce``: an all-reduce whose gradient passes through), so the
    loss is the masked mean over the global batch, and the aux loss is
    averaged over them. The logits are this rank's vocabulary shard there
    (tensor parallelism), and the CE the vocabulary-parallel one."""
    labels = batch["labels"]
    mask = batch["loss_mask"].to(torch.float32)
    P = cfg.frontend_embed_len
    if cfg.chunked_ce > 0 and cfg.family in TRANSFORMER_FAMILIES:
        hidden, aux, _ = forward(params, cfg, batch, return_hidden=True,
                                 plan=plan, ctx=ctx)
        nll_sum, denom = chunked_head_ce(params, cfg, hidden[:, P:], labels,
                                         mask, chunk=cfg.chunked_ce, ctx=ctx)
    else:
        logits, aux, _ = forward(params, cfg, batch, plan=plan, ctx=ctx)
        nll_sum, denom = cross_entropy(
            logits[:, P:], labels, mask, tp=shd.tensor_axis(ctx),
            vocab_start=transformer.vocab_range(cfg, ctx)[0])
    if shd.is_sharded(ctx):
        daxes = [ctx.axis(a) for a in ctx.data_axes]
        nll_sum, denom, aux = (comm.reduce(t.reshape(1), daxes)[0]
                               for t in (nll_sum, denom, aux))
        aux = aux / comm.flat_width(daxes)
    loss = nll_sum / torch.clamp(denom, min=1.0)
    total = loss
    if cfg.moe.num_experts > 0:
        total = total + cfg.moe.aux_loss_weight * aux
    metrics = {"loss": loss, "aux_loss": aux, "tokens": denom,
               "perplexity": torch.exp(torch.clamp(loss, max=20.0))}
    return total, metrics

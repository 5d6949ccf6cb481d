"""Serving engine: slot-based continuous batching over device-resident decode.

Counterpart of ``repro/serving/engine.py``, its telemetry included (the
plan's cost attribution, the compile-cache counters, the `serve` span;
the scheduler stamps the rest). The engine owns a fixed pool of
`max_batch` cache slots (rows of one pool cache) and an SLO-aware
`Scheduler` (serving/scheduler.py) that admits, preempts, quarantines and
retires requests between decode chunks:

* admission: with `prefill_chunk=0` (monolithic) a queued request is
  prefilled alone (B=1): its whole blocks run through one forward that also
  builds the compressed cache, the remaining S mod c tokens run through
  decode steps; its cache rows are copied into a free pool row, whose
  position counter starts at the prompt length. With `prefill_chunk=P`
  (chunked) the slot is claimed at t=0 and the prompt streams into the pool
  cache P tokens per scheduler round, interleaved with decode chunks, every
  co-prefilling row's next chunk batched into ONE padded (g, P) forward
  (`pool_prefill_chunk`, per-row offsets and valid counts as tensors); the
  sub-block remainders run through batched decode steps, one group per
  remainder length (`pool_prefill_remainder`);
* decode: the whole pool decodes `decode_chunk` tokens on the device
  (model.decode_scan), idle slots riding along finished-masked, and the
  host syncs once per chunk (`decode_chunk=None` takes the tuning table's
  value for the engine's device, else DEFAULT_DECODE_CHUNK; the table's
  hit/miss counters are drained into the telemetry after each serve); tokens are the argmax at `temperature` 0,
  else Gumbel-max draws from an explicit `torch.Generator` on the engine's
  device (`model.sample`);
* retirement: EOS or an exhausted token budget frees the slot;
* row surgery between chunks (the scheduler's preemption and fault
  recovery): `snapshot_pool_rows` copies rows to the host without
  touching the pool, `restore_pool_rows(_paged)` writes a snapshot back
  (a paged one into freshly allocated pages), `scrub_pool_row` zeroes a
  quarantined row, `corrupt_pool_row(_paged)` is the fault injector's
  corruption, with JAX's arithmetic in each leaf's dtype.

Every cache write, rope position, mask and block fold is per row, so a slot
decodes identically whatever its neighbours do: continuous scheduling gives
the same tokens as the static bucketed baseline (`serve_static`).

Pool storage (`cache_format`): "dense" is the attention kind's decode
cache in `cache_dtype` (the compressed cache for ``linformer_causal``, the
full KV cache for the ``standard`` baseline, whose block is 1 token: its
prompts prefill whole, monolithic or in P-token chunks, with no remainder
steps); "paged" keeps the ring and the compressed slots as int8 or
fp8 codes with fp32 scales (`page_dtype`), the slots in a shared arena of
pages (`arena_pages`, default capacity-equivalent to the dense pool) behind
a per-row page table that the scheduler's page allocator fills.

The pool cache is updated in place (the JAX engine donates buffers to the
same effect); the scheduler's `SlotPool` is its only owner.

The ssm and hybrid families (rwkv6-1.6b, zamba2-1.2b) keep one scalar
``length`` for every row of a cache, so no row can be admitted or retired
alone: `serve` falls back to the static bucketed path for them
(`supports_continuous_batching`), as JAX's does, and refuses what only the
scheduler offers. Their prompts prefill whole through one forward where
the admission block is 1 (rwkv6: no attention) and as whole Linformer
blocks plus decode steps for the rest (zamba2's shared block, c = 256).

On a mesh (`ctx`, a ParallelCtx over torch.distributed ranks) the plan is
resolved on the ctx and every pool the engine builds or restores is laid
out per the plan's ``cache_pspecs`` (``place_cache``): on a tp mesh each
rank holds its KV heads of every leaf, and the cache writers write this
rank's heads. Rows stay whole on every rank and every rank runs the same
host scheduler on the same tokens; the parameters are whole on every
rank. `snapshot_pool_rows` gathers the heads, so a snapshot's bytes and
CRC32 are the single-device ones, and a restore keeps this rank's heads
of them. The standard baseline's full cache stays whole (its decode runs
outside the plan).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cache as cache_lib
from repro_torch.data.pipeline import EOS
from repro_torch.kernels.common import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.parallel.plan import resolve_attention_plan
from repro_torch.telemetry import as_telemetry, plan_attribution
from repro_torch.tune import table as tuning

DEFAULT_DECODE_CHUNK = 32

# Leaves of the paged pool that live in the shared page arena, indexed by
# physical page (L, Np, ...), not by pool row: per-row gathers pass them
# whole (rows reach them only through their page tables).
PAGED_ARENA_KEYS = ("page_k", "page_v", "page_k_s", "page_v_s")
# The paged pool's per-row payload: the quantized ring and its scales.
PAGED_RING_KEYS = ("raw_k_q", "raw_v_q", "raw_k_s", "raw_v_s")


def bucket_requests(prompts: Sequence[Sequence[int]], max_batch: int
                    ) -> List[List[int]]:
    """Group request indices into equal-length buckets of ≤ max_batch."""
    by_len: Dict[int, List[int]] = {}
    for i, p in enumerate(prompts):
        by_len.setdefault(len(p), []).append(i)
    buckets = []
    for _, idxs in sorted(by_len.items()):
        for j in range(0, len(idxs), max_batch):
            buckets.append(idxs[j:j + max_batch])
    return buckets


def _per_request_max_new(max_new_tokens: Union[int, Sequence[int]],
                         n: int) -> List[int]:
    if isinstance(max_new_tokens, int):
        return [max_new_tokens] * n
    out = list(max_new_tokens)
    if len(out) != n:
        raise ValueError(f"max_new_tokens has {len(out)} entries "
                         f"for {n} prompts")
    return out


class ServingEngine:
    def __init__(
        self,
        params,
        cfg: ModelConfig,
        *,
        max_seq: int,
        device: Union[str, torch.device] = "cuda",
        cache_dtype=torch.bfloat16,
        temperature: float = 0.0,
        decode_chunk: Optional[int] = None,
        attention_backend: Optional[str] = None,
        prefill_chunk: int = 0,
        cache_format: str = "dense",
        arena_pages: Optional[int] = None,
        page_dtype: str = "int8",
        telemetry=None,
        ctx=None,
    ):
        self.device = resolve_device(device)
        if cfg.embedding_inputs or cfg.frontend_embed_len > 0:
            raise ValueError(
                f"config {cfg.name!r} (family {cfg.family!r}) takes "
                "frontend embeddings, but the engine serves token prompts "
                "only: drive model.forward and decode_step with the "
                "embeddings instead")
        if attention_backend is not None:
            cfg = cfg.with_attention_backend(attention_backend)
        self.plan = resolve_attention_plan(cfg.attention, ctx)
        self.ctx = ctx
        self.params = params
        self.cfg = cfg
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self.temperature = temperature
        if decode_chunk is None:
            decode_chunk = tuning.scalar(
                "decode_chunk", DEFAULT_DECODE_CHUNK,
                platform=tuning.platform_key(self.device))
        self.decode_chunk = max(1, decode_chunk)
        self.prefill_chunk = int(prefill_chunk)
        if cache_format not in ("dense", "paged"):
            raise ValueError(f"unknown cache_format {cache_format!r} "
                             "(expected 'dense' or 'paged')")
        self.cache_format = cache_format
        self.arena_pages = arena_pages
        self.page_dtype = page_dtype
        if self.paged:
            if cfg.attention.kind != "linformer_causal":
                raise ValueError(
                    "cache_format='paged' requires the linformer_causal "
                    f"attention family, got {cfg.attention.kind!r} (the "
                    "page size IS the attention block fold)")
            _, self._page_qmax = cache_lib.resolve_page_dtype(page_dtype)
        if not self.supports_continuous_batching and (
                self.paged or self.prefill_chunk):
            raise ValueError(
                f"family {cfg.family!r} has a shared-scalar cache: serve "
                "runs the static bucketed path, which prefills whole prompts"
                " into a dense cache, so cache_format='paged' and "
                "prefill_chunk > 0 (the continuous scheduler's pool and "
                "admission) do not apply")
        if self.prefill_chunk:
            blk = self._block()
            if self.prefill_chunk < blk or self.prefill_chunk % blk != 0:
                raise ValueError(
                    f"prefill_chunk={self.prefill_chunk} must be a positive "
                    f"multiple of the attention block size ({blk}) so chunk "
                    "boundaries land on block-fold boundaries")
        self.telemetry = as_telemetry(telemetry)
        # shape-level compile-cache proxies (see _note_compile)
        self._prefill_shapes: set = set()
        self._chunk_lengths: set = set()
        self._attributed: set = set()   # facades holding this plan's record
        self._record_plan_attribution(self.telemetry)

    # -- internals ------------------------------------------------------

    def _block(self) -> int:
        """Token granularity of admission: the Linformer block for the
        causal form, 1 for the standard baseline's full cache (a prompt
        prefills whole, with no remainder steps)."""
        a = self.cfg.attention
        if a.kind == "linformer_causal":
            return a.linformer.block_size
        return 1

    @property
    def paged(self) -> bool:
        return self.cache_format == "paged"

    def max_pages_per_row(self) -> int:
        """Page-table width: one page per block fold over the pool's token
        capacity (max_seq + the chunked-prefill slack)."""
        return (self.max_seq + self.prefill_chunk) // self._block()

    def resolved_arena_pages(self, max_batch: int) -> int:
        """Arena size of a `max_batch`-row pool: `arena_pages`, or one full
        table per row + TRASH (capacity-equivalent to the dense pool)."""
        if self.arena_pages is not None:
            return self.arena_pages
        return max_batch * self.max_pages_per_row() + 1

    def _record_plan_attribution(self, tel) -> None:
        """Emit the plan's cost-attribution record (backend, per-form FLOPs
        and comm-bytes estimates) into `tel`, once a facade, so a per-run
        `serve(telemetry=...)` override gets it too."""
        if not tel.enabled or tel in self._attributed:
            return
        self._attributed.add(tel)
        rec = plan_attribution(self.plan, self.cfg.attention,
                               max_seq=self.max_seq,
                               prefill_chunk=self.prefill_chunk or None)
        tel.record(rec.pop("kind"), **rec)

    def _note_compile(self, fn_name: str, hit: bool) -> None:
        """Count a shape-level compile-cache hit or miss under JAX's names.
        Nothing here compiles a shape: the counters keep JAX's proxy, a miss
        the first time a shape is seen (where JAX's jit would trace and
        compile) and a hit after."""
        if self.telemetry.enabled:
            self.telemetry.metrics.counter(
                "serving_compile_cache_hit_total" if hit
                else "serving_compile_cache_miss_total", fn=fn_name).inc()

    def _note_table_stats(self, tel=None) -> None:
        """Drain the tuning table's lookup counters into the metrics
        registry: how many lookups hit an entry of the table and how many
        fell back to the hand-picked defaults since the last drain. The
        port counts a lookup a call (JAX counts one a trace)."""
        tel = tel if tel is not None else self.telemetry
        if not tel.enabled:
            return
        stats = tuning.consume_stats()
        for key, name in (("hits", "tuning_table_hit_total"),
                          ("misses", "tuning_table_miss_total")):
            if stats[key]:
                tel.metrics.counter(name).inc(stats[key])

    def resolve_generator(self,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Generator:
        """`generator`, checked to live on the engine's device (a generator
        elsewhere raises; it is never moved), or a fresh one seeded 0
        there."""
        if generator is None:
            return torch.Generator(device=self.device).manual_seed(0)
        gd = generator.device
        if gd.type != self.device.type or (
                self.device.index is not None and gd.index is not None
                and gd.index != self.device.index):
            raise ValueError(f"generator on {gd}, engine on {self.device}: "
                             "pass a torch.Generator on the engine's device")
        return generator

    def _sample(self, logits: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        return model_lib.sample(logits, self.temperature, generator)

    @torch.no_grad()
    def prefill(self, tokens: np.ndarray) -> Tuple[Dict, torch.Tensor]:
        """tokens: (B, S) prompt. Returns (cache at t=S, last-token logits).
        The ⌊S/c⌋·c whole-block prefix runs through one forward that builds
        the cache; the remainder runs through decode steps."""
        B, S = tokens.shape
        c = self._block()
        nfull = (S // c) * c
        shape = (B, nfull)
        self._note_compile("prefill", hit=shape in self._prefill_shapes)
        self._prefill_shapes.add(shape)
        toks = torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device)
        logits = None
        if nfull == 0:
            cache = model_lib.init_cache(self.cfg, batch=B,
                                         max_seq=self.max_seq,
                                         dtype=self.cache_dtype,
                                         device=self.device, plan=self.plan)
        else:
            logits_all, _, cache = model_lib.forward(
                self.params, self.cfg, {"tokens": toks[:, :nfull]},
                return_cache=True, cache_max_seq=self.max_seq,
                cache_dtype=self.cache_dtype, plan=self.plan, ctx=self.ctx)
            logits = logits_all[:, -1]
        for t in range(nfull, S):
            logits_t, cache = model_lib.decode_step(
                self.params, self.cfg, toks[:, t:t + 1], cache,
                plan=self.plan, ctx=self.ctx)
            logits = logits_t[:, 0]
        return cache, logits

    @torch.no_grad()
    def decode_chunk_fn(self, cur: torch.Tensor, finished: torch.Tensor,
                        cache: Dict, n: int,
                        generator: Optional[torch.Generator] = None,
                        note_compile: bool = True):
        """One n-step device-resident decode chunk (model.decode_scan),
        sampling at the engine's temperature from `generator`; updates
        `cache` in place. Returns (tokens, cur, finished, bad, cache), all
        on the device. `note_compile` counts the chunk length in the
        compile-cache proxies, as each call of JAX's `_chunk_fn` does (the
        scheduler's pool counts each length once, as JAX's pool resolves
        it once)."""
        if note_compile:
            self._note_compile("decode_chunk",
                               hit=n in self._chunk_lengths)
            self._chunk_lengths.add(n)
        return model_lib.decode_scan(
            self.params, self.cfg, cur, finished, cache, n_steps=n,
            eos_id=EOS, temperature=self.temperature, generator=generator,
            plan=self.plan, ctx=self.ctx)

    # -- slot-pool surface (consumed by serving/scheduler.py) -------------

    def init_pool_cache(self, max_batch: int) -> Dict:
        """A fresh (max_batch)-row pool cache, every slot idle at t=0.

        Chunked prefill allocates `prefill_chunk` tokens of slack beyond
        max_seq: a padded final chunk writes its whole P-token window at
        the row's offset, and without slack a window crossing max_seq would
        be clamped down over earlier, still-valid slots. The slack only
        ever holds padding junk (budget checks cap real content at
        max_seq)."""
        slack = self.prefill_chunk           # 0 in monolithic mode
        if self.paged:
            a = self.cfg.attention
            return self.plan.place_cache(cache_lib.init_paged_cache(
                device=self.device, num_layers=self.cfg.num_layers,
                batch=max_batch, max_seq=self.max_seq + slack,
                block_size=a.linformer.block_size,
                block_slots=a.linformer.block_slots,
                num_kv_heads=a.num_kv_heads, head_dim=a.head_dim,
                arena_pages=self.resolved_arena_pages(max_batch),
                page_dtype=self.page_dtype))
        return model_lib.init_cache(self.cfg, batch=max_batch,
                                    max_seq=self.max_seq + slack,
                                    dtype=self.cache_dtype,
                                    device=self.device, plan=self.plan)

    @staticmethod
    def write_pool_slot(pool: Dict, slot_cache: Dict, row: int) -> Dict:
        """Admission write, in place: pool row `row` takes the B=1 cache
        `slot_cache`. Cache leaves are (L, B, ...) except `lengths` (B,)."""
        for key, v in pool.items():
            if key == "lengths":
                v[row] = slot_cache[key][0]
            else:
                v[:, row] = slot_cache[key][:, 0]
        return pool

    # -- chunked admission --------------------------------------------------

    @staticmethod
    def _gather_rows(pool: Dict, idx: torch.Tensor) -> Dict:
        """Copies of pool rows `idx` as a B=len(idx) sub-cache. Cache leaves
        are (L, B, ...) except `lengths` (B,); paged arena leaves pass
        whole (the sub-cache's page tables keep indexing the shared arena,
        which the forward updates in place)."""
        return {k: (v if k in PAGED_ARENA_KEYS else
                    v.index_select(0 if k == "lengths" else 1, idx))
                for k, v in pool.items()}

    def _scatter_rows(self, pool: Dict, sub: Dict, rows: Sequence[int]
                      ) -> None:
        """Write a sub-cache back into pool rows `rows` (the inverse of
        `_gather_rows`), in place. Of a row listed more than once (the
        padding of `_pad_rows`) the last copy lands, as in the JAX
        engine's scatter: the copies differ under MoE, where a duplicate
        competes with its original for expert capacity and drops first."""
        last = {row: j for j, row in enumerate(rows)}
        idx = torch.as_tensor(list(last), device=self.device)
        src = torch.as_tensor(list(last.values()), device=self.device)
        for k, v in pool.items():
            if k in PAGED_ARENA_KEYS:
                continue
            if k == "lengths":
                v[idx] = sub[k][src]
            else:
                v[:, idx] = sub[k][:, src]

    @staticmethod
    def _pad_rows(rows: Sequence[int], *arrays: np.ndarray, pad_to: int):
        """Pad a row batch to exactly `pad_to` by duplicating the last row
        (and the matching rows of every per-row array), as the JAX engine
        does: a dense model's duplicate writes the same state twice; an
        MoE model's duplicates take part in the routing (see
        `_scatter_rows`). The scheduler pads to its pool size, so every
        admission round runs the same shapes."""
        g = len(rows)
        if g == 0:
            raise ValueError("empty prefill row batch")
        if pad_to < g:
            raise ValueError(f"pad_to={pad_to} smaller than batch {g}")
        rows = list(rows) + [rows[-1]] * (pad_to - g)
        padded = [np.concatenate([a] + [a[-1:]] * (pad_to - g), axis=0)
                  for a in arrays]
        return rows, padded

    @torch.no_grad()
    def pool_prefill_chunk(self, pool: Dict, rows: Sequence[int],
                           tokens: np.ndarray, n_valid: np.ndarray,
                           pad_to: int) -> Tuple[Dict, torch.Tensor]:
        """Advance rows' prefill by one padded chunk forward, in place.
        tokens: (g, prefill_chunk), padded at the end; n_valid: (g,) real
        token counts. Returns (pool, last-valid logits (g, V) on the
        device)."""
        g = len(rows)
        rows, (tokens, n_valid) = self._pad_rows(rows, tokens, n_valid,
                                                 pad_to=pad_to)
        idx = torch.as_tensor(rows, device=self.device)
        sub = self._gather_rows(pool, idx)
        logits, sub = model_lib.prefill_chunk(
            self.params, self.cfg,
            torch.as_tensor(np.asarray(tokens, np.int64), device=self.device),
            sub, torch.as_tensor(np.asarray(n_valid), device=self.device),
            plan=self.plan, ctx=self.ctx)
        self._scatter_rows(pool, sub, rows)
        return pool, logits[:g]

    @torch.no_grad()
    def pool_prefill_remainder(self, pool: Dict, rows: Sequence[int],
                               tokens: np.ndarray, pad_to: int
                               ) -> Tuple[Dict, torch.Tensor]:
        """Feed rows' final sub-block remainder tokens ((g, rem), rem <
        block size) through batched decode steps, in place: the monolithic
        path's remainder loop, batched over a remainder-length group.
        Returns (pool, final-token logits (g, V) on the device)."""
        g = len(rows)
        rows, (tokens,) = self._pad_rows(rows, tokens, pad_to=pad_to)
        idx = torch.as_tensor(rows, device=self.device)
        sub = self._gather_rows(pool, idx)
        toks = torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device)
        logits = None
        for t in range(toks.shape[1]):
            lg, sub = model_lib.decode_step(self.params, self.cfg,
                                            toks[:, t:t + 1], sub,
                                            plan=self.plan, ctx=self.ctx)
            logits = lg[:, 0]
        self._scatter_rows(pool, sub, rows)
        return pool, logits[:g]

    def reset_pool_row(self, pool: Dict, row: int) -> Dict:
        """Mark pool row `row` empty at t=0 for chunked prefill, in place.
        Only `lengths` needs resetting: a previous tenant's K/V is never
        visible (every mask stops at the row's committed length). A paged
        row also drops its table, so no fold can reach a page that has
        changed hands."""
        pool["lengths"][row] = 0
        if self.paged:
            pool["page_table"][:, row] = -1
        return pool

    # -- the paged pool (cache_format="paged") ----------------------------

    def _page_table_row(self, page_ids: Sequence[int]) -> torch.Tensor:
        """A row's block-ordered page ids as a (maxp,) table row, -1 past
        the end."""
        maxp = self.max_pages_per_row()
        if len(page_ids) > maxp:
            raise ValueError(f"{len(page_ids)} pages exceed the table "
                             f"width {maxp}")
        tab = np.full((maxp,), -1, np.int32)
        tab[:len(page_ids)] = page_ids
        return torch.as_tensor(tab, device=self.device)

    @torch.no_grad()
    def write_pool_slot_paged(self, pool: Dict, slot_cache: Dict, row: int,
                              page_ids: Sequence[int]) -> Dict:
        """Monolithic admission into a paged pool, in place: quantize the
        request's dense B=1 slot cache (ring per (token, head), compressed
        slots per (block, head)) into `row`'s ring and the freshly
        allocated `page_ids` (one per committed prompt block, in block
        order; blocks past them go to TRASH)."""
        pdt = pool["page_k"].dtype
        trash = pool["page_k"].shape[1] - 1
        for src, dq, ds in (("raw_k", "raw_k_q", "raw_k_s"),
                            ("raw_v", "raw_v_q", "raw_v_s")):
            q, s = cache_lib.quantize_blockwise(
                slot_cache[src], (4,), dtype=pdt, qmax=self._page_qmax)
            pool[dq][:, row] = q[:, 0]
            pool[ds][:, row] = s[:, 0]
        L, Np, r, Hkv, Dh = pool["page_k"].shape
        maxp = pool["page_table"].shape[2]
        tab = self._page_table_row(page_ids)
        dst = torch.where(tab >= 0, tab, torch.full_like(tab, trash)).long()
        for src, dq, ds in (("comp_k", "page_k", "page_k_s"),
                            ("comp_v", "page_v", "page_v_s")):
            blocks = slot_cache[src][:, 0].reshape(L, maxp, r, Hkv, Dh)
            q, s = cache_lib.quantize_blockwise(
                blocks, (2, 4), dtype=pdt, qmax=self._page_qmax)
            pool[dq][:, dst] = q
            pool[ds][:, dst] = s
        pool["page_table"][:, row] = tab
        pool["lengths"][row] = slot_cache["lengths"][0]
        return pool

    def scrub_arena_pages(self, pool: Dict, page_ids: Sequence[int]) -> Dict:
        """Zero arena pages, payload and scales, in place: the page
        allocator's scrub-before-reuse callback (a freed page never carries
        one request's K/V into the next tenant)."""
        if len(page_ids) == 0:
            return pool
        ids = torch.as_tensor(list(page_ids), device=self.device)
        for k in PAGED_ARENA_KEYS:
            pool[k][:, ids] = 0
        return pool

    def write_table_row(self, pool: Dict, row: int,
                        page_ids: Sequence[int]) -> Dict:
        """Publish `row`'s block-ordered page list to the device table, in
        place (-1 past the end, so unallocated folds go to TRASH)."""
        pool["page_table"][:, row] = self._page_table_row(page_ids)
        return pool

    def clear_table_row(self, pool: Dict, row: int) -> Dict:
        """Retirement: point every later fold of the idle row at TRASH
        before its pages return to the free list."""
        return self.write_table_row(pool, row, ())

    def prefill_request(self, tokens: Sequence[int],
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[Dict, int]:
        """Prefill ONE request (B=1). Returns (slot cache positioned at the
        prompt length, first sampled token); one host sync."""
        cache, logits = self.prefill(np.asarray([list(tokens)], np.int64))
        return cache, int(self._sample(logits, generator)[0].item())

    # -- row surgery (preemption, fault recovery, fault injection) ---------

    def snapshot_pool_rows(self, pool: Dict, rows: Sequence[int]
                           ) -> List[Dict]:
        """Per-row B=1 sub-caches of pool rows `rows`, for `capture` to copy
        to the host; the pool is not touched. Dense: views of the rows
        (O(c + M) per row). Paged: the ring, counters and the row's
        committed pages (`lengths // c`, gathered through its table), so a
        snapshot holds no bytes of unallocated table entries. On a tp mesh
        each row's heads are gathered (every rank calls this), so the
        snapshot is the single-device one."""
        if not self.paged:
            return [self._whole_heads({k: (v[row:row + 1] if k == "lengths"
                                           else v[:, row:row + 1])
                                       for k, v in pool.items()})
                    for row in rows]
        sub = self._gather_rows_paged(
            pool, torch.as_tensor(list(rows), device=self.device))
        c = self._block()
        npv = (sub["lengths"] // c).tolist()
        out = []
        for j in range(len(rows)):
            out.append(self._whole_heads(
                {k: (v[j:j + 1] if k == "lengths" else
                     v[:, j, :npv[j]] if k.startswith("pages_") else
                     v[:, j:j + 1]) for k, v in sub.items()}))
        return out

    def _whole_heads(self, rows: Dict) -> Dict:
        """Row leaves of a pool laid out per cache_pspecs, whole."""
        if not self.plan.shards_cache or not self._placed:
            return rows
        return self.plan.gather_cache(rows)

    def _local_heads(self, rows: Dict) -> Dict:
        """Whole row leaves (a snapshot's), cut to this rank's heads."""
        if not self.plan.shards_cache or not self._placed:
            return rows
        return self.plan.place_cache({k: v.to(self.device)
                                      for k, v in rows.items()})

    @property
    def _placed(self) -> bool:
        """Whether the pool is laid out per cache_pspecs: the compressed
        cache is, the standard baseline's full cache is not."""
        return self.cfg.attention.kind == "linformer_causal"

    @staticmethod
    def _gather_rows_paged(pool: Dict, idx: torch.Tensor) -> Dict:
        """Snapshot gather of a paged pool: per-row ring and lengths, plus
        the payload and scale of EVERY table entry (unallocated entries
        clamp to page 0; `snapshot_pool_rows` keeps only the committed
        pages)."""
        g = {k: v.index_select(0 if k == "lengths" else 1, idx)
             for k, v in pool.items() if k not in PAGED_ARENA_KEYS}
        Np = pool["page_k"].shape[1]
        safe = g.pop("page_table")[0].clamp(0, Np - 1).long()    # (g, maxp)
        for src, dst in (("page_k", "pages_k"), ("page_v", "pages_v"),
                         ("page_k_s", "pages_k_s"),
                         ("page_v_s", "pages_v_s")):
            g[dst] = pool[src][:, safe]          # (L, g, maxp, ...)
        return g

    def restore_pool_rows(self, pool: Dict, sub: Dict, row: int) -> Dict:
        """Write a dense snapshot's B=1 sub-cache back into pool row `row`,
        in place: the byte-exact inverse of `snapshot_pool_rows`."""
        sub = self._local_heads(sub)
        for k, v in pool.items():
            src = sub[k].to(device=v.device, dtype=v.dtype)
            if k == "lengths":
                v[row] = src[0]
            else:
                v[:, row] = src[:, 0]
        return pool

    def restore_pool_rows_paged(self, pool: Dict, sub: Dict, row: int,
                                page_ids: Sequence[int]) -> Dict:
        """Paged inverse of `snapshot_pool_rows`, in place: the ring and
        counter by row, the snapshot's pages into the freshly allocated
        `page_ids` (as many as the snapshot holds), the table row pointing
        at them. Physical placement may differ from capture; rows reach
        pages only through the table, so the resumed math is the same.
        Past the pages, zero pages land in TRASH, as in JAX."""
        npv = len(page_ids)
        sub = self._local_heads(sub)
        for k, v in sub.items():
            if k.startswith("pages_") and v.shape[1] != npv:
                raise ValueError(f"snapshot holds {v.shape[1]} pages in {k} "
                                 f"but {npv} pages were allocated")
        for k in PAGED_RING_KEYS:
            pool[k][:, row] = sub[k][:, 0].to(device=self.device,
                                              dtype=pool[k].dtype)
        trash = pool["page_k"].shape[1] - 1
        pad = npv < self.max_pages_per_row()
        ids = torch.as_tensor(list(page_ids) + [trash] * pad,
                              device=self.device, dtype=torch.long)
        for sk, pk in (("pages_k", "page_k"), ("pages_v", "page_v"),
                       ("pages_k_s", "page_k_s"), ("pages_v_s", "page_v_s")):
            v = sub[sk].to(device=self.device, dtype=pool[pk].dtype)
            if pad:
                v = torch.cat([v, v.new_zeros((v.shape[0], 1) + v.shape[2:])],
                              dim=1)
            pool[pk][:, ids] = v
        pool["page_table"][:, row] = self._page_table_row(page_ids)
        pool["lengths"][row] = sub["lengths"][0].to(self.device)
        return pool

    def scrub_pool_row(self, pool: Dict, row: int) -> Dict:
        """Zero a quarantined row, in place: a faulty row may hold NaN,
        which (unlike finite stale bytes) leaks through a later tenant's
        additive masks in the plain route. Dense: every leaf of the row
        and its counter. Paged: the ring and its scales, the counter and
        the table row; the row's pages are zeroed by the allocator's
        scrub-before-reuse when they are freed."""
        if self.paged:
            for k in PAGED_RING_KEYS:
                pool[k][:, row] = 0
            pool["page_table"][:, row] = -1
            pool["lengths"][row] = 0
            return pool
        for k, v in pool.items():
            if k == "lengths":
                v[row] = 0
            else:
                v[:, row] = 0
        return pool

    @staticmethod
    def corrupt_pool_row(pool: Dict, row: int, mode: str) -> Dict:
        """Fault injection on a dense pool, in place: every leaf of row
        `row` but `lengths` is poisoned with NaN (mode 'nan') or garbled
        as x·(-1.5) + 0.25 in its own dtype (mode 'garble', finite)."""
        if mode not in ("nan", "garble"):
            raise ValueError(f"unknown corruption mode {mode!r}")
        for k, v in pool.items():
            if k != "lengths":
                v[:, row] = _corrupt(v[:, row], mode, paged=False)
        return pool

    def corrupt_pool_row_paged(self, pool: Dict, row: int,
                               page_ids: Sequence[int], mode: str) -> Dict:
        """Fault injection on a paged pool, in place: the row's ring and the
        pages it owns (TRASH too while its table is not full, as in JAX).
        Integer payloads take x ^ 0x55 in 'garble' mode and stay intact in
        'nan' mode, where NaN enters through the fp32 scales; float leaves
        (the scales, fp8 payloads) as in `corrupt_pool_row`."""
        if mode not in ("nan", "garble"):
            raise ValueError(f"unknown corruption mode {mode!r}")
        for k in PAGED_RING_KEYS:
            pool[k][:, row] = _corrupt(pool[k][:, row], mode, paged=True)
        trash = pool["page_k"].shape[1] - 1
        ids = list(dict.fromkeys(
            list(page_ids)
            + [trash] * (len(page_ids) < self.max_pages_per_row())))
        idx = torch.as_tensor(ids, device=self.device, dtype=torch.long)
        for k in PAGED_ARENA_KEYS:
            pool[k][:, idx] = _corrupt(pool[k][:, idx], mode, paged=True)
        return pool

    # -- public API -------------------------------------------------------

    def generate_batch(self, tokens: np.ndarray, max_new_tokens: int,
                       generator: Optional[torch.Generator] = None
                       ) -> np.ndarray:
        """Greedy or temperature generation for one equal-length batch.
        tokens: (B, S). Returns (B, max_new_tokens), in device-resident
        `decode_chunk`-token chunks with one host sync per chunk.
        `generator` (default: seeded 0 on the engine's device) feeds the
        sampler at temperature > 0."""
        cache, logits = self.prefill(tokens)
        return self.decode_tokens(cache, logits, max_new_tokens, generator)

    def decode_tokens(self, cache: Dict, logits: torch.Tensor,
                      max_new_tokens: int,
                      generator: Optional[torch.Generator] = None
                      ) -> np.ndarray:
        """Decode phase given a prefilled cache (updated in place) and
        last-token logits."""
        generator = self.resolve_generator(generator)
        B = logits.shape[0]
        outs = np.full((B, max_new_tokens), EOS, np.int64)
        finished = torch.zeros(B, dtype=torch.bool, device=self.device)
        cur = self._sample(logits, generator)
        done = 0
        while done < max_new_tokens:
            n = min(self.decode_chunk, max_new_tokens - done)
            toks, cur, finished, _bad, cache = self.decode_chunk_fn(
                cur, finished, cache, n, generator)
            host = torch.cat([toks, finished[:, None].to(toks.dtype)],
                             dim=1).cpu().numpy()      # the chunk's one sync
            outs[:, done:done + n] = host[:, :n]
            done += n
            if host[:, n].all():
                break
        return outs

    def generate_batch_per_token(self, tokens: np.ndarray,
                                 max_new_tokens: int,
                                 generator: Optional[torch.Generator] = None
                                 ) -> np.ndarray:
        """`generate_batch` by the per-token decode loop, one host round
        trip a token: the baseline the device-resident chunks are measured
        against. Same tokens as `generate_batch` at temperature 0."""
        cache, logits = self.prefill(tokens)
        return self.decode_tokens_per_token(cache, logits, max_new_tokens,
                                            generator)

    def decode_tokens_per_token(self, cache: Dict, logits: torch.Tensor,
                                max_new_tokens: int,
                                generator: Optional[torch.Generator] = None
                                ) -> np.ndarray:
        """Per-token decode phase (the baseline counterpart of
        `decode_tokens`): one decode step and one host sync per token;
        finished rows emit EOS."""
        generator = self.resolve_generator(generator)
        B = logits.shape[0]
        outs = np.zeros((B, max_new_tokens), np.int64)
        finished = torch.zeros(B, dtype=torch.bool, device=self.device)
        cur = self._sample(logits, generator)
        for i in range(max_new_tokens):
            cur = torch.where(finished, torch.full_like(cur, EOS), cur)
            finished = finished | (cur == EOS)
            host = torch.stack([cur, finished.to(cur.dtype)]).cpu().numpy()
            outs[:, i] = host[0]                    # the token's one sync
            if host[1].all():
                outs[:, i + 1:] = EOS
                break
            logits_t, cache = model_lib.decode_step(
                self.params, self.cfg, cur[:, None], cache, plan=self.plan,
                ctx=self.ctx)
            cur = self._sample(logits_t[:, 0], generator)
        return outs

    @property
    def supports_continuous_batching(self) -> bool:
        """Slot scheduling needs per-row position counters, which only the
        transformer-family caches carry; ssm/hybrid caches share a scalar
        position."""
        return self.cfg.family in model_lib.TRANSFORMER_FAMILIES

    def _check_budgets(self, prompts, budgets) -> None:
        for i, p in enumerate(prompts):
            if len(p) == 0:
                raise ValueError(f"request {i}: empty prompt")
            if budgets[i] <= 0:
                raise ValueError(f"request {i}: max_new_tokens="
                                 f"{budgets[i]} must be positive")
            if len(p) + budgets[i] > self.max_seq:
                raise ValueError(
                    f"request {i}: prompt {len(p)} + budget {budgets[i]} "
                    f"exceeds max_seq={self.max_seq}")

    def serve(self, prompts: Sequence[Sequence[int]],
              max_new_tokens: Union[int, Sequence[int]],
              max_batch: int = 8,
              *,
              arrival_chunks: Optional[Sequence[int]] = None,
              priorities: Optional[Sequence[int]] = None,
              deadlines: Optional[Sequence[Optional[int]]] = None,
              max_queue: Optional[int] = None,
              max_retries: int = 2,
              snapshot_chunks: int = 0,
              nan_guard: bool = True,
              fault_injector=None,
              on_token: Optional[Callable[[int, int], None]] = None,
              on_complete: Optional[Callable[[int, List[int]], None]] = None,
              generator: Optional[torch.Generator] = None,
              return_scheduler: bool = False,
              telemetry=None):
        """Serve mixed-length requests with slot-based continuous batching:
        a `max_batch`-slot pool, admission/retirement between decode chunks
        (serving/scheduler.py). `max_new_tokens` is one int or one per
        request; `arrival_chunks` optionally replays an arrival trace
        (request i is admissible after that many ticks of virtual time).

        SLO knobs, all defaulting to plain FCFS: `priorities` (per-request
        class, lower = more urgent; a strictly more urgent arrival preempts
        the least urgent running slot), `deadlines` (absolute deadline in
        ticks, None = none), `max_queue` (bounded admission queue: overflow
        sheds the least valued entry), `max_retries` and `snapshot_chunks`
        (fault recovery: retry budget, last-good-snapshot refresh period),
        `nan_guard` (quarantine rows whose logits go non-finite),
        `fault_injector` (serving/faults.py). `generator` feeds sampling at
        temperature > 0 (default: a generator seeded 0 on the engine's
        device; one on another device raises).

        `telemetry` overrides the engine's `Telemetry` facade for this run
        (span trace, per-request timelines, per-priority SLO histograms);
        None uses the engine's own, by default the disabled no-op.

        Returns outputs ordered like `prompts`, a `ShedResult` in place of
        the tokens of a shed request (or (outputs, scheduler) with
        return_scheduler=True, for stats).

        Families whose cache has no per-row positions (ssm/hybrid) fall
        back to `serve_static`, as in JAX: the scheduler's options
        (`return_scheduler`, `arrival_chunks` and the SLO knobs
        `priorities`, `deadlines`, `max_queue`, `fault_injector`,
        `snapshot_chunks`) raise ValueError; `generator` is not used (each
        bucket samples from a generator seeded 0, as JAX's fallback
        ignores its key); the streaming callbacks fire after the serve."""
        from repro_torch.serving.scheduler import Request, Scheduler
        budgets = _per_request_max_new(max_new_tokens, len(prompts))
        if not self.supports_continuous_batching:
            slo = (priorities is not None or deadlines is not None
                   or max_queue is not None or fault_injector is not None
                   or snapshot_chunks)
            if return_scheduler or arrival_chunks is not None or slo:
                raise ValueError(
                    f"family {self.cfg.family!r} has a shared-scalar cache: "
                    "no continuous scheduler (serve falls back to the "
                    "static bucketed path, which has no scheduler stats, "
                    "no SLO/fault handling, and cannot replay an arrival "
                    "trace)")
            outputs = self.serve_static(prompts, budgets,
                                        max_batch=max_batch)
            for i, out in enumerate(outputs):
                if on_token is not None:
                    for tok in out:
                        on_token(i, tok)
                if on_complete is not None:
                    on_complete(i, out)
            return outputs
        n = len(prompts)
        arrivals = list(arrival_chunks) if arrival_chunks is not None \
            else [0] * n
        prios = list(priorities) if priorities is not None else [0] * n
        dls = list(deadlines) if deadlines is not None else [None] * n
        for name, seq in (("arrival_chunks", arrivals),
                          ("priorities", prios), ("deadlines", dls)):
            if len(seq) != n:
                raise ValueError(f"{name} has {len(seq)} entries "
                                 f"for {n} prompts")
        self._check_budgets(prompts, budgets)
        tel = telemetry if telemetry is not None else self.telemetry
        self._record_plan_attribution(tel)
        sched = Scheduler(self, max_batch, generator,
                          max_queue=max_queue, max_retries=max_retries,
                          snapshot_chunks=snapshot_chunks,
                          nan_guard=nan_guard, fault_injector=fault_injector,
                          telemetry=tel)
        for i, p in enumerate(prompts):
            sched.submit(Request(rid=i, tokens=tuple(p),
                                 max_new_tokens=budgets[i],
                                 arrival_chunk=arrivals[i],
                                 priority=prios[i],
                                 deadline_ticks=dls[i]))
        with tel.span("serve", cat="engine", n_requests=n,
                      max_batch=max_batch):
            results = sched.run(on_token=on_token, on_complete=on_complete)
        self._note_table_stats(tel)
        outputs = [results[i] for i in range(n)]
        if return_scheduler:
            return outputs, sched
        return outputs

    def serve_static(self, prompts: Sequence[Sequence[int]],
                     max_new_tokens: Union[int, Sequence[int]],
                     max_batch: int = 8) -> List[List[int]]:
        """Static bucketed baseline: bucket by equal prompt length, decode
        each bucket to its longest request budget (each bucket from a
        generator seeded 0, as JAX's buckets each start from key 0)."""
        budgets = _per_request_max_new(max_new_tokens, len(prompts))
        self._check_budgets(prompts, budgets)
        results: List[Optional[List[int]]] = [None] * len(prompts)
        for bucket in bucket_requests(prompts, max_batch):
            toks = np.asarray([list(prompts[i]) for i in bucket], np.int64)
            n = max(budgets[i] for i in bucket)
            gen = self.generate_batch(toks, n)
            for row, i in enumerate(bucket):
                out = gen[row, :budgets[i]].tolist()
                if EOS in out:
                    out = out[:out.index(EOS)]
                results[i] = out
        return results  # type: ignore

    def cache_bytes(self, batch: int) -> int:
        """Decode-cache footprint of a `batch`-row pool, in bytes: every
        leaf of the model's decode cache (the family's layout: the
        compressed or full KV cache; the recurrent states, with the shared
        block's compressed entries for the hybrid), or in paged mode the
        quantized ring, its scales, the page arena (`arena_pages`, or the
        capacity-equivalent default) and the table."""
        if self.paged:
            from repro_torch.models import attention as attn_lib
            return transformer.cache_nbytes(attn_lib.paged_decode_cache_spec(
                self.cfg.attention, num_layers=self.cfg.num_layers,
                batch=batch, max_seq=self.max_seq,
                arena_pages=self.arena_pages, page_dtype=self.page_dtype))
        cache = model_lib.init_cache(self.cfg, batch=batch,
                                     max_seq=self.max_seq,
                                     dtype=self.cache_dtype, device="meta")
        return sum(v.numel() * v.element_size()
                   for v in transformer.flatten(cache).values())


def _round_fp8(x: torch.Tensor, nan_sign: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """fp32 -> float8_e4m3fn as JAX rounds it: to nearest even, and NaN
    past the largest finite value (torch saturates there). Built on the
    codes so every device gives the same bits: an overflow keeps x's sign;
    a NaN takes `nan_sign` (0x80 or 0), the sign of the NaN it came from,
    as XLA:CPU propagates it."""
    ok = x.abs() <= 464.0
    code = torch.where(ok, x, torch.zeros_like(x)).to(dtype).view(
        torch.uint8)
    sign = torch.where(torch.isnan(x), nan_sign,
                       torch.signbit(x).to(torch.uint8) << 7)
    return torch.where(ok, code, sign | 0x7F).view(dtype)


def _corrupt(x: torch.Tensor, mode: str, *, paged: bool) -> torch.Tensor:
    """The JAX engine's leaf corruption, bit for bit (held to JAX on the
    CPU, and on the card to the CPU).

    'nan': NaN for float leaves; integer leaves become 0 on a dense pool
    (JAX's full_like(int, nan)) and stay intact on a paged pool. 'garble':
    x·(-1.5) + 0.25 in the leaf's dtype. fp32 as XLA:CPU fuses it (one
    rounding: exact in fp64, then rounded); bf16 one rounding per op;
    float8_e4m3fn one rounding per op, computed in fp32 (torch has no fp8
    arithmetic), overflow to NaN as in JAX; integers: the constants cast
    to the dtype (-1 and 0) on a dense pool, x ^ 0x55 on a paged pool."""
    if not x.dtype.is_floating_point:
        if mode == "nan":
            return x if paged else torch.zeros_like(x)
        return x ^ 0x55 if paged else -x
    if mode == "nan":
        return torch.full_like(x, float("nan"))
    if x.dtype == torch.float32:
        return (x.double() * -1.5 + 0.25).float()
    if x.element_size() == 1:                           # float8_e4m3fn
        y = _round_fp8(x.float() * -1.5, x.view(torch.uint8) & 0x80,
                       x.dtype)
        return _round_fp8(y.float() + 0.25, y.view(torch.uint8) & 0x80,
                          x.dtype)
    return x * -1.5 + 0.25

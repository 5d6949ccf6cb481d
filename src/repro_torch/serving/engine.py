"""Serving engine: slot-based continuous batching over device-resident decode.

Counterpart of the dense, monolithic-admission subset of
``repro/serving/engine.py``. The engine owns a fixed pool of `max_batch`
cache slots (rows of one pool cache) and a FCFS `Scheduler`
(serving/scheduler.py) that admits and retires requests between decode
chunks:

* admission: a queued request is prefilled alone (B=1): its whole blocks
  run through one forward that also builds the compressed cache, the
  remaining S mod c tokens run through decode steps; its cache rows are
  copied into a free pool row, whose position counter starts at the prompt
  length;
* decode: the whole pool decodes `decode_chunk` tokens on the device
  (model.decode_scan), idle slots riding along finished-masked, and the
  host syncs once per chunk;
* retirement: EOS or an exhausted token budget frees the slot.

Every cache write, rope position, mask and block fold is per row, so a slot
decodes identically whatever its neighbours do: continuous scheduling gives
the same tokens as the static bucketed baseline (`serve_static`).

The pool cache is updated in place (the JAX engine donates buffers to the
same effect); the scheduler's `SlotPool` is its only owner.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import EOS
from repro_torch.kernels.common import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.parallel.plan import resolve_attention_plan

DEFAULT_DECODE_CHUNK = 32


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
        decode_chunk: Optional[int] = None,
        attention_backend: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        if attention_backend is not None:
            cfg = cfg.with_attention_backend(attention_backend)
        self.plan = resolve_attention_plan(cfg.attention)
        self.params = params
        self.cfg = cfg
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self.decode_chunk = max(1, decode_chunk or DEFAULT_DECODE_CHUNK)

    # -- internals ------------------------------------------------------

    def _block(self) -> int:
        return self.cfg.attention.linformer.block_size

    @torch.no_grad()
    def prefill(self, tokens: np.ndarray) -> Tuple[Dict, torch.Tensor]:
        """tokens: (B, S) prompt. Returns (cache at t=S, last-token logits).
        The ⌊S/c⌋·c whole-block prefix runs through one forward that builds
        the cache; the remainder runs through decode steps."""
        B, S = tokens.shape
        c = self._block()
        nfull = (S // c) * c
        toks = torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device)
        logits = None
        if nfull == 0:
            cache = model_lib.init_cache(self.cfg, batch=B,
                                         max_seq=self.max_seq,
                                         dtype=self.cache_dtype,
                                         device=self.device)
        else:
            logits_all, _, cache = model_lib.forward(
                self.params, self.cfg, {"tokens": toks[:, :nfull]},
                return_cache=True, cache_max_seq=self.max_seq,
                cache_dtype=self.cache_dtype, plan=self.plan)
            logits = logits_all[:, -1]
        for t in range(nfull, S):
            logits_t, cache = model_lib.decode_step(
                self.params, self.cfg, toks[:, t:t + 1], cache,
                plan=self.plan)
            logits = logits_t[:, 0]
        return cache, logits

    @torch.no_grad()
    def decode_chunk_fn(self, cur: torch.Tensor, finished: torch.Tensor,
                        cache: Dict, n: int):
        """One n-step device-resident decode chunk (model.decode_scan);
        updates `cache` in place. Returns (tokens, cur, finished, bad,
        cache), all on the device."""
        return model_lib.decode_scan(
            self.params, self.cfg, cur, finished, cache, n_steps=n,
            eos_id=EOS, plan=self.plan)

    # -- slot-pool surface (consumed by serving/scheduler.py) -------------

    def init_pool_cache(self, max_batch: int) -> Dict:
        """A fresh (max_batch)-row pool cache, every slot idle at t=0."""
        return model_lib.init_cache(self.cfg, batch=max_batch,
                                    max_seq=self.max_seq,
                                    dtype=self.cache_dtype,
                                    device=self.device)

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

    def prefill_request(self, tokens: Sequence[int]) -> Tuple[Dict, int]:
        """Prefill ONE request (B=1). Returns (slot cache positioned at the
        prompt length, first greedy token); one host sync."""
        cache, logits = self.prefill(np.asarray([list(tokens)], np.int64))
        return cache, int(torch.argmax(logits[0]).item())

    # -- public API -------------------------------------------------------

    def generate_batch(self, tokens: np.ndarray, max_new_tokens: int
                       ) -> np.ndarray:
        """Greedy generation for one equal-length batch.
        tokens: (B, S). Returns (B, max_new_tokens), in device-resident
        `decode_chunk`-token chunks with one host sync per chunk."""
        cache, logits = self.prefill(tokens)
        return self.decode_tokens(cache, logits, max_new_tokens)

    def decode_tokens(self, cache: Dict, logits: torch.Tensor,
                      max_new_tokens: int) -> np.ndarray:
        """Decode phase given a prefilled cache (updated in place) and
        last-token logits."""
        B = logits.shape[0]
        outs = np.full((B, max_new_tokens), EOS, np.int64)
        finished = torch.zeros(B, dtype=torch.bool, device=self.device)
        cur = torch.argmax(logits, dim=-1)
        done = 0
        while done < max_new_tokens:
            n = min(self.decode_chunk, max_new_tokens - done)
            toks, cur, finished, _bad, cache = self.decode_chunk_fn(
                cur, finished, cache, n)
            host = torch.cat([toks, finished[:, None].to(toks.dtype)],
                             dim=1).cpu().numpy()      # the chunk's one sync
            outs[:, done:done + n] = host[:, :n]
            done += n
            if host[:, n].all():
                break
        return outs

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
              on_token: Optional[Callable[[int, int], None]] = None,
              on_complete: Optional[Callable[[int, List[int]], None]] = None,
              return_scheduler: bool = False):
        """Serve mixed-length requests with slot-based continuous batching
        (FCFS): a `max_batch`-slot pool, admission/retirement between
        decode chunks. `max_new_tokens` is one int or one per request;
        `arrival_chunks` optionally replays an arrival trace (request i is
        admissible after that many chunks of virtual time). Returns outputs
        ordered like `prompts` (or (outputs, scheduler) with
        return_scheduler=True, for stats)."""
        from repro_torch.serving.scheduler import Request, Scheduler
        budgets = _per_request_max_new(max_new_tokens, len(prompts))
        n = len(prompts)
        arrivals = list(arrival_chunks) if arrival_chunks is not None \
            else [0] * n
        if len(arrivals) != n:
            raise ValueError(f"arrival_chunks has {len(arrivals)} entries "
                             f"for {n} prompts")
        self._check_budgets(prompts, budgets)
        sched = Scheduler(self, max_batch)
        for i, p in enumerate(prompts):
            sched.submit(Request(rid=i, tokens=tuple(p),
                                 max_new_tokens=budgets[i],
                                 arrival_chunk=arrivals[i]))
        results = sched.run(on_token=on_token, on_complete=on_complete)
        outputs = [results[i] for i in range(n)]
        if return_scheduler:
            return outputs, sched
        return outputs

    def serve_static(self, prompts: Sequence[Sequence[int]],
                     max_new_tokens: Union[int, Sequence[int]],
                     max_batch: int = 8) -> List[List[int]]:
        """Static bucketed baseline: bucket by equal prompt length, decode
        each bucket to its longest request budget."""
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
        """Decode-cache footprint of a `batch`-row pool, in bytes."""
        from repro_torch.models.attention import decode_cache_spec
        spec = decode_cache_spec(self.cfg.attention,
                                 num_layers=self.cfg.num_layers, batch=batch,
                                 max_seq=self.max_seq,
                                 dtype=self.cache_dtype)
        return transformer.cache_nbytes(spec)

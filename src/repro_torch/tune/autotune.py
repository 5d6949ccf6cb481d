"""Benchmark-driven sweep that regenerates the port's tuning table.

Counterpart of ``repro/tune/autotune.py``. Times the real entry points on
a device: the chunked reference form for its ``q_chunk_blocks``, and live
`ServingEngine.serve` loops for the scheduler scalars, with warm-up and the
median of k runs per candidate, an ``autotune_trial`` telemetry span per
trial and an ``autotune_trials_total`` counter, and writes the winners to
``TUNING_TORCH.json`` through `tune.table`. Run offline::

    python -m repro_torch.tune.autotune [--smoke] [--out PATH] [--device cuda]

Never imported on the serving or training path.

Search space (the JAX package's grids, shapes, trial labels and
tie-breaking, so that an injected timer gives its entries):

* **causal_chunked** (per seq bucket): ``q_chunk_blocks`` over the
  divisors of the block count.
* **scalars** (platform-wide): ``decode_chunk`` and ``prefill_chunk``
  timed through real serves of a 2-layer model (per generated token; the
  KNEE winner, the smallest candidate within 10% of the best, so that the
  scheduler's tick granularity is never refined for a noise-level win),
  and ``chunked_min_seq`` as the smallest probed S where the chunked
  reference beats the plain form (full mode only; smoke keeps the
  default).

Three differences from the JAX sweep:

* **No exact-form sweep.** The JAX package tunes the exact form's
  ``block_q``/``block_s`` grid; the port's kernels 5 and 6 fix their tiles
  at compile time and take no runtime tile, so there is nothing to time.
* **Backend "auto" in both serve sweeps.** JAX times ``prefill_chunk`` on
  its reference route to keep Pallas interpret overhead out; a card has
  none, so the scalars are timed through the kernels the serves run.
* **Blocks of 16 in the decode sweep's model** (JAX: 8), because kernel 1
  takes a multiple of 16 (`DECODE_SWEEP_BLOCK`).

Determinism: candidate order is fixed, the winner is the FIRST minimal
candidate (`min` is stable), and every timing goes through one
`_measure(label, fn)` choke point whose `timer` argument tests replace with
a fixed injector: the same injected times give the same table. Trial
labels are stable strings, e.g. ``causal_chunked/S512_c64_r8/qcb2`` or
``scalars/decode_chunk/8``.
"""
from __future__ import annotations

import argparse
import logging
import os
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import causal as causal_lib
from repro_torch.kernels import common as kcommon
from repro_torch.telemetry import as_telemetry
from repro_torch.tune.table import (TuningTable, default_path, platform_key,
                                    shape_bucket)

log = logging.getLogger("repro_torch.tune.autotune")

# Candidate grids (the JAX package's).
QCB_CANDIDATES = (1, 2, 4, 8, 16)
DECODE_CHUNK_CANDIDATES = {"smoke": (4, 8, 32), "full": (8, 16, 32, 64)}
PREFILL_CHUNK_MULTS = {"smoke": (2, 4), "full": (4, 8, 16)}
MIN_SEQ_PROBES = (2048, 4096, 8192)   # full mode only

# A scalar winner must beat the next-larger candidate by more than this
# before the scheduler's tick granularity is refined for it: decode /
# prefill chunk lengths trade host-round overhead against scheduling
# granularity, so noise-level wins keep the coarser (cheaper) setting.
KNEE_TOLERANCE = 1.10

# the decode_chunk sweep's model takes Linformer blocks of 16 tokens, where
# the JAX sweep's takes 8: kernel 1 tiles its queries by 16 or 64 rows
# within a block (kernels/common.bca_query_tile), so a card's serve needs a
# multiple of 16
DECODE_SWEEP_BLOCK = 16

# causal_chunked sweep shapes (S, c, r, H, Hkv, Dh)
CAUSAL_SHAPES = {
    "smoke": ((512, 64, 8, 2, 2, 16),),
    "full": ((8192, 64, 8, 2, 2, 16),),
}

Timer = Callable[[str], float]


def _sync() -> None:
    """Wait for the card's queued work (results of a trial may be device
    tensors or host token lists)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _measure(label: str, fn: Callable[[], object], *, warmup: int,
             iters: int, tel, timer: Optional[Timer]) -> float:
    """Median wall µs of `fn()` after `warmup` calls, each ended by a
    sync, or the injected `timer(label)` when tests replace real timing.
    One `autotune_trials_total` increment a trial either way, and one
    `autotune_trial` span around a timed one."""
    tel.metrics.counter("autotune_trials_total").inc()
    if timer is not None:
        return float(timer(label))
    with tel.span("autotune_trial", cat="autotune", label=label,
                  iters=iters):
        for _ in range(warmup):
            fn()
            _sync()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            _sync()
            times.append((time.perf_counter() - t0) * 1e6)
    us = float(np.median(times))
    log.info("trial %s: %.1f us (median of %d)", label, us, iters)
    return us


def _knee(results: Sequence[Tuple[int, float]],
          tol: float = KNEE_TOLERANCE) -> Tuple[int, float]:
    """(candidate, µs) of the SMALLEST candidate within `tol` of the
    best: candidates arrive smallest first."""
    best_us = min(us for _, us in results)
    for cand, us in results:
        if us <= tol * best_us:
            return cand, us
    return results[-1]


def _randn(gen: torch.Generator, shape, scale: float = 1.0,
           device=None) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32) * scale


# ---------------------------------------------------------------------------
# causal_chunked form: q_chunk_blocks for the memory-bounded reference
# ---------------------------------------------------------------------------


def tune_causal_chunked(table: TuningTable, *,
                        shapes: Sequence[Tuple[int, ...]],
                        warmup: int = 1, iters: int = 3, telemetry=None,
                        timer: Optional[Timer] = None,
                        platform: Optional[str] = None,
                        device="cuda") -> None:
    """Sweep the chunked reference form's chunk width per seq bucket
    (candidates restricted to divisors of the block count: a non-divisor
    silently degrades to chunks of one block inside the form)."""
    tel = as_telemetry(telemetry)
    dev = kcommon.resolve_device(device)
    platform = platform or platform_key(dev)
    for (S, c, r, H, Hkv, Dh) in shapes:
        nb = S // c
        cands = [n for n in QCB_CANDIDATES if nb % n == 0]
        default = kcommon.DEFAULT_Q_CHUNK_BLOCKS if \
            nb % kcommon.DEFAULT_Q_CHUNK_BLOCKS == 0 else 1
        if default not in cands:
            cands.append(default)
        gen = torch.Generator(device=dev).manual_seed(1)
        q = _randn(gen, (1, S, H, Dh), device=dev)
        k = _randn(gen, (1, S, Hkv, Dh), device=dev)
        v = _randn(gen, (1, S, Hkv, Dh), device=dev)
        E = _randn(gen, (c, r), c ** -0.5, device=dev)
        F = _randn(gen, (c, r), c ** -0.5, device=dev)
        tag = f"causal_chunked/S{S}_c{c}_r{r}"

        def timed(n: int) -> float:
            def fn():
                with torch.no_grad():
                    return causal_lib.blockwise_causal_attention_chunked(
                        q, k, v, E, F, block_size=c, q_chunk_blocks=n)
            return _measure(f"{tag}/qcb{n}", fn, warmup=warmup,
                            iters=iters, tel=tel, timer=timer)

        results = [(n, timed(n)) for n in sorted(cands)]
        best, trial_us = min(results, key=lambda r: r[1])
        default_us = dict(results)[default]
        table.add(platform=platform, form="causal_chunked",
                  bucket=shape_bucket(seq=S),
                  params={"q_chunk_blocks": int(best)},
                  trial_us=trial_us, default_us=default_us, trials=iters)


# ---------------------------------------------------------------------------
# scalars: decode_chunk / prefill_chunk (live serve loops), chunked_min_seq
# ---------------------------------------------------------------------------


def _serving_setup(max_seq: int, *, block: int = 8, backend: str = "auto",
                   device="cuda"):
    """A tiny linformer_causal model for the scheduler-scalar sweeps (the
    JAX sweep's shape), random weights from seed 0 on `device`."""
    from repro_torch.configs.base import (AttentionConfig, LinformerConfig,
                                          ModelConfig)
    from repro_torch.models import model as model_lib
    cfg = ModelConfig(
        name="autotune-serving", num_layers=2, d_model=64, vocab_size=512,
        max_seq_len=max_seq,
        attention=AttentionConfig(
            kind="linformer_causal", backend=backend, num_heads=4,
            num_kv_heads=2, head_dim=16,
            linformer=LinformerConfig(block_size=block, block_slots=4)),
        dtype="float32", remat="none")
    params = model_lib.init_params(cfg, seed=0, device=device)
    return cfg, params


def tune_scalars(table: TuningTable, *, mode: str = "full",
                 warmup: int = 1, iters: int = 3, telemetry=None,
                 timer: Optional[Timer] = None,
                 platform: Optional[str] = None, device="cuda") -> None:
    """Sweep the platform-wide scheduler scalars through REAL serve loops
    (µs per generated token) and add one combined scalars entry.
    `prefill_chunk` is ADVISORY: 0 (monolithic admission) stays the
    engine's default; the recorded value is the best chunk length when
    chunked admission is asked for."""
    from repro_torch.serving.engine import DEFAULT_DECODE_CHUNK, ServingEngine
    tel = as_telemetry(telemetry)
    dev = kcommon.resolve_device(device)
    platform = platform or platform_key(dev)
    quick = mode != "full"
    rng = np.random.default_rng(0)
    params_out: Dict[str, int] = {}

    # -- decode_chunk: per-token serve wall over a short decode-heavy trace
    n_req, budget, pool = (4, 12, 2) if quick else (8, 24, 4)
    prompts = [[int(t) for t in rng.integers(4, 512, 16)]
               for _ in range(n_req)]
    budgets = [budget] * n_req
    d_block = DECODE_SWEEP_BLOCK
    max_seq = ((16 + budget + 64 + d_block - 1) // d_block) * d_block
    cfg, mparams = _serving_setup(max_seq, block=d_block, device=dev)
    cands = DECODE_CHUNK_CANDIDATES["smoke" if quick else "full"]
    cands = sorted(set(cands) | {DEFAULT_DECODE_CHUNK})
    n_tok = float(sum(budgets))

    def timed_decode(n: int) -> float:
        eng = ServingEngine(mparams, cfg, max_seq=max_seq, device=dev,
                            cache_dtype=torch.float32, decode_chunk=n)
        return _measure(f"scalars/decode_chunk/{n}",
                        lambda: eng.serve(prompts, budgets, max_batch=pool),
                        warmup=warmup, iters=iters, tel=tel,
                        timer=timer) / n_tok

    dec_results = [(n, timed_decode(n)) for n in cands]
    best_dc, trial_us = _knee(dec_results)
    default_us = dict(dec_results)[DEFAULT_DECODE_CHUNK]
    params_out["decode_chunk"] = int(best_dc)

    # -- prefill_chunk: per-token serve wall, long prompts, chunked mode
    block = 16
    long_lens = (96, 112) if quick else (192, 224, 256)
    p_budget = 4
    p_prompts = [[int(t) for t in rng.integers(4, 512, L)]
                 for L in long_lens]
    p_budgets = [p_budget] * len(p_prompts)
    p_cands = sorted(block * m for m in
                     PREFILL_CHUNK_MULTS["smoke" if quick else "full"])
    p_max = max(long_lens) + p_budget + max(p_cands)
    p_max = ((p_max + max(p_cands) - 1) // max(p_cands)) * max(p_cands)
    p_cfg, p_params = _serving_setup(p_max, block=block, device=dev)
    p_tok = float(sum(len(p) + b for p, b in zip(p_prompts, p_budgets)))

    def timed_prefill(P: int) -> float:
        eng = ServingEngine(p_params, p_cfg, max_seq=p_max, device=dev,
                            cache_dtype=torch.float32, decode_chunk=4,
                            prefill_chunk=P)
        return _measure(f"scalars/prefill_chunk/{P}",
                        lambda: eng.serve(p_prompts, p_budgets,
                                          max_batch=2),
                        warmup=warmup, iters=iters, tel=tel,
                        timer=timer) / p_tok

    pf_results = [(P, timed_prefill(P)) for P in p_cands]
    best_pf, _ = _knee(pf_results)
    params_out["prefill_chunk"] = int(best_pf)

    # -- chunked_min_seq: smallest probed S where the chunked reference
    # form beats the plain one (full mode only: the probes are the
    # expensive part of the sweep, and smoke keeps the default anyway)
    if not quick:
        threshold = causal_lib.CHUNKED_ATTENTION_MIN_SEQ
        c, r_, H, Hkv, Dh = 64, 8, 2, 2, 16
        for S in MIN_SEQ_PROBES:
            gen = torch.Generator(device=dev).manual_seed(2)
            q = _randn(gen, (1, S, H, Dh), device=dev)
            k = _randn(gen, (1, S, Hkv, Dh), device=dev)
            v = _randn(gen, (1, S, Hkv, Dh), device=dev)
            E = _randn(gen, (c, r_), c ** -0.5, device=dev)
            F = _randn(gen, (c, r_), c ** -0.5, device=dev)

            def plain():
                with torch.no_grad():
                    return causal_lib.blockwise_causal_attention(
                        q, k, v, E, F, block_size=c)

            def chunk():
                with torch.no_grad():
                    return causal_lib.blockwise_causal_attention_chunked(
                        q, k, v, E, F, block_size=c)

            t_plain = _measure(f"scalars/chunked_min_seq/plain_S{S}", plain,
                               warmup=warmup, iters=iters, tel=tel,
                               timer=timer)
            t_chunk = _measure(f"scalars/chunked_min_seq/chunked_S{S}",
                               chunk, warmup=warmup, iters=iters, tel=tel,
                               timer=timer)
            if t_chunk <= t_plain:
                threshold = min(threshold, S)
                break
        params_out["chunked_min_seq"] = int(threshold)

    table.add(platform=platform, form="scalars", bucket=None,
              params=params_out, trial_us=trial_us, default_us=default_us,
              trials=iters)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def build_table(mode: str = "full", *, telemetry=None,
                timer: Optional[Timer] = None,
                platform: Optional[str] = None,
                device="cuda") -> TuningTable:
    """Run the sweep on `device` and return the resulting table (not yet
    saved). mode: "full" | "smoke"; smoke shrinks shapes and candidates
    and skips the chunked_min_seq probes. `platform` defaults to the
    device's key (`tune.table.platform_key`)."""
    quick = mode != "full"
    iters = 3 if quick else 5
    table = TuningTable(meta={"generated_by": "repro_torch.tune.autotune",
                              "mode": mode})
    kw = dict(warmup=1, iters=iters, telemetry=telemetry, timer=timer,
              platform=platform, device=device)
    tune_causal_chunked(
        table, shapes=CAUSAL_SHAPES["smoke" if quick else "full"], **kw)
    tune_scalars(table, mode=mode, **kw)
    return table


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not read ({exc.__class__.__name__})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def main(argv: Optional[List[str]] = None) -> str:
    ap = argparse.ArgumentParser(
        description="Regenerate the port's tuning table on a device.")
    ap.add_argument("--smoke", action="store_true",
                    help="the quick sweep (no chunked_min_seq probes)")
    ap.add_argument("--out", default=None,
                    help="output path (default: $REPRO_TORCH_TUNING_PATH "
                         "or TUNING_TORCH.json at the repo root)")
    ap.add_argument("--device", default="cuda",
                    help="the device to tune (CUDA unless 'cpu' is asked)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    dev = kcommon.resolve_device(args.device)
    mode = "smoke" if args.smoke else "full"
    t0 = time.perf_counter()
    table = build_table(mode, device=dev)
    if dev.type == "cuda":
        table.meta["card"] = card_line()
    out = args.out or default_path()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    path = table.save(out)
    for e in table.entries:
        log.info("entry %s %s %s: %s (%.1f us, default %.1f us)",
                 e["platform"], e["form"], e["bucket"], e["params"],
                 e["trial_us"], e["default_us"])
    log.info("wrote %s (%d entries, %s mode, %.1f s)", path,
             len(table.entries), mode, time.perf_counter() - t0)
    return path


if __name__ == "__main__":
    main()

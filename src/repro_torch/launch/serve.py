"""Serving launcher of the PyTorch port: random weights from seed 0 for an
arch, synthetic mixed-length traffic through the continuous-batching
scheduler (default) or the static bucketed baseline. Reports through
`logging`.

    python -m repro_torch.launch.serve --arch qwen3-8b
    python -m repro_torch.launch.serve --arch qwen3-8b --smoke --device cpu
    python -m repro_torch.launch.serve --arch qwen3-8b --smoke --device cpu \
        --prefill-chunk 32

    python -m repro_torch.launch.serve --arch qwen3-8b --smoke --device cpu \
        --attention standard
    python -m repro_torch.launch.serve --arch qwen3-8b --smoke --device cpu \
        --requests 12 --max-batch 2 --priority-classes 3 --deadline-ticks 8 \
        --max-queue 6
    python -m repro_torch.launch.serve --arch qwen3-8b --smoke --device cpu \
        --ckpt-dir "$TMPDIR/repro_torch_train_ckpt/qwen3-8b"

    python -m repro_torch.launch.serve --arch zamba2-1.2b --smoke --device cpu
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --smoke --device cpu

--arch takes every token-input config of the port: qwen3-8b, qwen3-14b,
nemotron-4-15b, qwen1.5-110b, qwen3-moe-30b-a3b, kimi-k2-1t-a32b,
rwkv6-1.6b and zamba2-1.2b (the engine refuses the frontend configs
internvl2-2b and musicgen-large; the whole kimi-k2, 2 TB in bf16, fits no
single card, so serve its --smoke config). The ssm and hybrid configs
(rwkv6-1.6b, zamba2-1.2b) keep one scalar position for every row: the
continuous scheduler falls back to the static bucketed one, with a logged
line saying so, as the JAX launcher does, and --attention leaves the
attention-free rwkv6 as it is. --ckpt-dir restores the params of the
latest step a Trainer saved there (the train launcher's
--ckpt-dir/<arch>), in the config's dtype (float32 with --smoke), and
logs the step; a directory without a step raises. Without it the weights
are random from seed 0.

--attention overrides the config's attention kind (standard |
linformer_causal), as the JAX launcher's flag does. Prompt lengths are
drawn from {c/2, c, c + c/8, 2c}, c the engine's admission block: the
Linformer block size for linformer_causal (at full width, c = 256, most
prompts reach the blockwise-causal prefill kernel and every remainder goes
through decode steps); for the standard baseline, whose block is one token,
from the JAX launcher's {8, 16, 16, 32}. The cache capacity (--max-seq)
defaults to 16 Linformer blocks for either kind.

--temperature (default: ServeConfig's, 0 = greedy) samples from a
generator seeded 0 on the device. The SLO flags are assigned as the JAX
launcher assigns them: --priority-classes k puts request i in class i mod k
(0 most urgent), --deadline-ticks gives the priority-0 requests that
absolute deadline, --max-queue bounds the admission queue. The scheduler's
counters line and one SHED line per shed request are logged.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import numpy as np

from repro_torch.configs.base import ServeConfig

log = logging.getLogger("repro_torch.serve")


def synthetic_prompts(vocab_size: int, block: int, requests: int):
    """The launcher's traffic: `requests` prompts of tokens drawn from seed
    0, their lengths from {c/2, c, c + c/8, 2c} for an admission block c > 1,
    else from {8, 16, 16, 32}."""
    rng = np.random.default_rng(0)
    c = block
    lengths = [c // 2, c, c + c // 8, 2 * c] if c > 1 else [8, 16, 16, 32]
    return [list(rng.integers(4, vocab_size, int(rng.choice(lengths))))
            for _ in range(requests)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--attention", default=None,
                    choices=["standard", "linformer_causal"],
                    help="override the config's attention kind")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config, in float32")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the latest step saved in "
                         "this checkpoint directory (the Trainer's "
                         "checkpoint_dir, e.g. <train --ckpt-dir>/<arch>)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=0,
                    help="cache capacity per request (0 = 16 blocks)")
    ap.add_argument("--decode-chunk", type=int, default=32,
                    help="tokens per device-resident decode chunk")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked admission: stream prompts into the pool "
                         "this many tokens per scheduler round (a multiple "
                         "of the attention block size; 0 = monolithic)")
    ap.add_argument("--backend", default=None,
                    choices=["auto", "reference", "fused"],
                    help="attention backend (default: the config's 'auto' "
                         "-> CUDA kernels for CUDA tensors)")
    ap.add_argument("--scheduler", default="continuous",
                    choices=["continuous", "static"])
    ap.add_argument("--temperature", type=float,
                    default=ServeConfig().temperature,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--priority-classes", type=int, default=1,
                    help="request i gets priority i mod this (0 = most "
                         "urgent; urgent arrivals preempt running "
                         "lower-priority slots); 1 = plain FCFS")
    ap.add_argument("--deadline-ticks", type=int, default=0,
                    help="absolute deadline, in scheduler ticks, of every "
                         "priority-0 request (0 = none); infeasible "
                         "deadlines are shed at admission")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound the admission queue; overflow sheds the "
                         "least valued entry (0 = unbounded)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[serve] %(message)s")

    import torch
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.models.transformer import param_bytes, torch_dtype
    from repro_torch.serving import ServingEngine

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg, dtype="float32")
    if args.attention and cfg.family != "ssm":
        cfg = cfg.with_attention_kind(args.attention)
    max_seq = args.max_seq or 16 * cfg.attention.linformer.block_size
    params = M.init_params(cfg, seed=0, device=args.device)
    if args.ckpt_dir:
        restored, meta = Checkpointer(args.ckpt_dir).restore_latest(
            {"params": params})
        if restored is None:
            raise FileNotFoundError(f"--ckpt-dir {args.ckpt_dir!r} holds no "
                                    "checkpoint step")
        params = restored["params"]
        log.info("restored step %d from %s", meta["step"], args.ckpt_dir)
    log.info("%s: %d layers, %.2f GB of params on %s", cfg.name,
             cfg.num_layers, param_bytes(params) / 1e9, args.device)

    eng = ServingEngine(params, cfg, max_seq=max_seq, device=args.device,
                        cache_dtype=torch_dtype(cfg.dtype),
                        temperature=args.temperature,
                        decode_chunk=args.decode_chunk,
                        attention_backend=args.backend,
                        prefill_chunk=args.prefill_chunk)
    prompts = synthetic_prompts(cfg.vocab_size, eng._block(), args.requests)
    prios = ([i % args.priority_classes for i in range(len(prompts))]
             if args.priority_classes > 1 else None)
    deadlines = None
    if args.deadline_ticks:
        deadlines = [args.deadline_ticks if (prios is None or p == 0)
                     else None for p in (prios or [0] * len(prompts))]
    sync = torch.cuda.synchronize if eng.device.type == "cuda" else (
        lambda: None)
    mode = args.scheduler
    if mode == "continuous" and not eng.supports_continuous_batching:
        log.info("%r cache has no per-row positions; falling back to the "
                 "static bucketed scheduler", cfg.family)
        mode = "static"
    sync()
    t0 = time.perf_counter()
    sched = None
    if mode == "continuous":
        outs, sched = eng.serve(prompts, args.max_new_tokens,
                                max_batch=args.max_batch,
                                priorities=prios, deadlines=deadlines,
                                max_queue=args.max_queue or None,
                                return_scheduler=True)
    else:
        outs = eng.serve_static(prompts, args.max_new_tokens,
                                max_batch=args.max_batch)
    sync()
    dt = time.perf_counter() - t0
    shed = [o for o in outs if not isinstance(o, list)]
    n_tok = sum(len(o) for o in outs if isinstance(o, list))
    occ = ""
    if sched is not None:
        occ = (f", occupancy {sched.stats.mean_occupancy:.2f} over "
               f"{sched.stats.chunks} chunks")
        if args.prefill_chunk:
            occ += (f"; chunked prefill: {sched.stats.prefill_forwards} "
                    f"forwards for {sched.stats.prefill_tokens} prompt "
                    "tokens")
    log.info("%s: %d requests, %d tokens in %.2fs (%.1f tok/s)%s; "
             "cache/request %d B", mode, len(prompts), n_tok, dt,
             n_tok / dt, occ, eng.cache_bytes(args.max_batch)
             // args.max_batch)
    if sched is not None:
        log.info("%s", sched.stats.counters_line())
    for o in shed:
        log.info("  req%d SHED at tick %d: %s (priority %d)", o.rid, o.tick,
                 o.reason, o.priority)
    for i, o in enumerate(outs[:4]):
        if isinstance(o, list):
            log.info("  req%d (%d prompt toks) -> %s", i, len(prompts[i]),
                     o[:10])
    return outs


if __name__ == "__main__":
    main()

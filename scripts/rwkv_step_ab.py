#!/usr/bin/env python3
"""Time chip_smoke's [train-ssm] step, rwkv6-1.6b at full width and depth
(24 layers, remat "full", 2 × 4096 tokens, AdamW), with the time mix's
working dtype (`models/rwkv6.WKV_DTYPE[model dtype]`) fp32 and fp64, on
one CUDA card.

    python3 scripts/rwkv_step_ab.py [--steps 3] [--dtypes bfloat16 float32]

For each model dtype the two working dtypes run in turns (fp32, fp64,
fp64, fp32), each turn one warm-up step and `--steps` timed steps,
continuing from the last turn's parameters on the same batch (host clock
around steps that end in a synchronize), with the peak memory of the
turn. A bf16 model's working dtype is its WKV's (the port's: fp32); an
fp32 model's is its whole time mix's (the port's: fp64; at fp32 the mix
runs as it did before). Prints the card's name and power limit first.
"""
import argparse
import dataclasses
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("rwkv_step_ab: this script needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.pipeline import (DataState, SyntheticCorpus,
                                           make_causal_batch)
    from repro_torch.models import model as tmodel
    from repro_torch.models import rwkv6
    from repro_torch.models.transformer import flatten
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    run = cs.TRAIN_SSM_RUN
    port_dtypes = dict(rwkv6.WKV_DTYPE)
    for dtype in args.dtypes:
        cfg = dataclasses.replace(get_config(cs.SSM_ARCH), dtype=dtype)
        cfg_dtype = getattr(torch, dtype)
        opt = OptimizerConfig(lr=3e-4, warmup_steps=1, total_steps=100)
        batch = make_causal_batch(SyntheticCorpus(cfg.vocab_size, seed=0),
                                  DataState(0, 0), batch=run["batch"],
                                  seq=run["seq"])
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params = tmodel.init_params(cfg, seed=0, device=dev)
        for p in flatten(params).values():
            p.requires_grad_(True)
        state = adamw_init(params, opt)
        step = make_train_step(cfg, opt)
        times = {}
        for wkv in ("float32", "float64", "float64", "float32"):
            rwkv6.WKV_DTYPE[cfg_dtype] = getattr(torch, wkv)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            params, state, m = step(params, state, batch)     # warm-up
            loss = float(m["loss"])
            ms = []
            for _ in range(args.steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, m = step(params, state, batch)
                float(m["loss"])
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            times.setdefault(wkv, []).extend(ms)
            print(f"[rwkv-step-ab] {cfg.name} {dtype}, {cfg.num_layers} "
                  f"layers, remat {cfg.remat}, {run['batch']} x "
                  f"{run['seq']}, time mix in {wkv}: step ms "
                  f"{', '.join(f'{x:.1f}' for x in ms)}; warm-up loss "
                  f"{loss:.4f}; peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
                  flush=True)
        print(f"[rwkv-step-ab] {dtype}: median step ms, time mix in fp32 "
              f"{statistics.median(times['float32']):.1f}, in fp64 "
              f"{statistics.median(times['float64']):.1f}", flush=True)
        del params, state, step
        torch.cuda.empty_cache()
        rwkv6.WKV_DTYPE.update(port_dtypes)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

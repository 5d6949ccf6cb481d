"""Long-context decode with the compressed Linformer cache — the technique's
serving-side payoff. Prefills an 8k-token context (parallel, block-compressed
on the fly) and decodes with a cache of c + r·(n/c) slots instead of n.

    PYTHONPATH=src python examples_torch/long_context_decode.py \\
        --context 8192 [--device cpu]

Runs on the CUDA card by default (kernel 1 in the prefill, kernel 3 in
each decode step); `--device cpu` runs their plain PyTorch versions.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import LinformerConfig
from repro_torch.models import model as M
from repro_torch.models.transformer import flatten


def config(context: int):
    """SMOKE qwen3-8b in fp32 with c 256, r 16, long enough for twice the
    context."""
    base = get_smoke_config("qwen3-8b")
    return dataclasses.replace(
        base, dtype="float32", max_seq_len=context * 2,
        attention=dataclasses.replace(
            base.attention,
            linformer=LinformerConfig(k=64, sharing="layerwise",
                                      block_size=256, block_slots=16)))


def main(argv=None, params=None):
    """Prefill the context, decode `--new-tokens` greedily; returns what it
    printed. `params` (the config's layout on the device) replaces the
    seeded weights."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--context", type=int, default=8192)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = config(args.context)
    if params is None:
        params = M.init_params(cfg, seed=0, device=args.device)
    dev = next(iter(flatten(params).values())).device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    c = cfg.attention.linformer.block_size
    r = cfg.attention.linformer.block_slots

    rng = np.random.default_rng(0)
    ctx_tokens = torch.from_numpy(
        rng.integers(4, cfg.vocab_size, (1, args.context))).to(dev)

    max_seq = args.context + args.new_tokens + c
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, _, cache = M.forward(params, cfg, {"tokens": ctx_tokens},
                                     return_cache=True, cache_max_seq=max_seq,
                                     cache_dtype=torch.float32)
    sync()
    t_prefill = time.perf_counter() - t0
    comp_slots = (args.context // c) * r
    print(f"prefill {args.context} tokens in {t_prefill:.2f}s -> "
          f"compressed cache: {comp_slots} slots + {c} raw "
          f"(vs {args.context} full-KV slots, "
          f"{args.context / (comp_slots + c):.1f}x smaller)")

    cur = logits[:, -1].argmax(-1)[:, None]
    t0 = time.perf_counter()
    outs = []
    with torch.no_grad():
        for _ in range(args.new_tokens):
            lg, cache = M.decode_step(params, cfg, cur, cache)
            cur = lg[:, 0].argmax(-1)[:, None]
            outs.append(int(cur[0, 0]))
    sync()
    dt = time.perf_counter() - t0
    print(f"decoded {args.new_tokens} tokens in {dt:.2f}s "
          f"({dt / args.new_tokens * 1e3:.1f} ms/token) -> {outs[:10]}...")
    cache_bytes = sum(x.numel() * x.element_size()
                      for x in flatten(cache).values())
    full_bytes = (2 * cfg.num_layers * max_seq *
                  cfg.attention.num_kv_heads * cfg.attention.head_dim * 4)
    print(f"cache bytes: {cache_bytes} (full-KV baseline would be "
          f"{full_bytes}, {full_bytes / cache_bytes:.1f}x)")
    return {"context": args.context, "compressed_slots": comp_slots,
            "raw_slots": c, "prefill_s": t_prefill, "decode_s": dt,
            "tokens": outs, "cache_bytes": cache_bytes,
            "full_bytes": full_bytes, "ratio": full_bytes / cache_bytes}


if __name__ == "__main__":
    main()

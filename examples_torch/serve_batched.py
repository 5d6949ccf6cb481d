"""Batched serving example: mixed-length requests through the
continuous-batching scheduler (slot pool + streaming completions) against
the static bucketed baseline, and the Linformer compressed decode cache
against the standard full-KV baseline on the same weights.

    PYTHONPATH=src python examples_torch/serve_batched.py [--device cpu]

Runs on the CUDA card by default (kernels 1, 3 and 4: the prefill, the
decode step and the chunked prefill); `--device cpu` runs their plain
PyTorch versions.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M
from repro_torch.serving import ServingEngine


def main(argv=None, params=None):
    """Serve the example's requests; returns what it printed. `params`
    (the config's layout on the device) replaces the seeded weights."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype="float32")
    if params is None:
        params = M.init_params(cfg, seed=0, device=args.device)

    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(4, cfg.vocab_size, rng.choice([8, 8, 16])))
               for _ in range(6)]
    budgets = [int(b) for b in rng.choice([4, 8, 16], len(prompts))]
    print(f"{len(prompts)} requests, prompt lengths "
          f"{[len(p) for p in prompts]}, budgets {budgets}")

    # continuous batching: 3-slot pool over 6 requests, streaming completions
    eng = ServingEngine(params, cfg, max_seq=256, device=args.device,
                        cache_dtype=torch.float32, decode_chunk=8)
    done_order = []
    t0 = time.perf_counter()
    outs, sched = eng.serve(
        prompts, budgets, max_batch=3,
        on_complete=lambda rid, toks: done_order.append(rid),
        return_scheduler=True)
    dt = time.perf_counter() - t0
    for i, o in enumerate(outs):
        print(f"  req{i}: {len(o)} tokens -> {o[:8]}...")
    occupancy = sched.stats.mean_occupancy
    print(f"continuous (3 slots): {dt:.2f}s, completion order {done_order}, "
          f"mean occupancy {occupancy:.2f}")
    order = list(done_order)

    # static bucketed baseline — identical outputs, more row-steps
    t0 = time.perf_counter()
    outs_static = eng.serve_static(prompts, budgets, max_batch=3)
    dt_static = time.perf_counter() - t0
    assert outs == outs_static, "continuous/static outputs diverged"
    print(f"static bucketed:      {dt_static:.2f}s, outputs identical")

    # chunked admission: a long prompt streams into its slot 32 tokens per
    # round (PREFILLING state) instead of stalling the pool for one big
    # forward; short requests keep decoding and finish first
    eng_ck = ServingEngine(params, cfg, max_seq=256, device=args.device,
                           cache_dtype=torch.float32, decode_chunk=8,
                           prefill_chunk=32)
    long_prompt = list(rng.integers(4, cfg.vocab_size, 160))
    done_order.clear()
    outs_ck, sched_ck = eng_ck.serve(
        [long_prompt] + prompts, [8] + budgets, max_batch=3,
        on_complete=lambda rid, toks: done_order.append(rid),
        return_scheduler=True)
    assert outs_ck[1:] == outs, "chunked admission changed short outputs"
    stats = sched_ck.stats
    print(f"chunked admission: all {len(prompts) + 1} prompts "
          f"({stats.prefill_tokens} prompt tokens, one of them "
          f"160 tokens long) streamed in via "
          f"{stats.prefill_forwards} batched prefill launches; "
          f"completion order {done_order} (the long request rid=0 "
          f"finishes last — it prefilled while the others decoded)")

    # standard-attention baseline on the SAME weights (E/F simply unused)
    cfg_std = cfg.with_attention_kind("standard")
    eng_std = ServingEngine(params, cfg_std, max_seq=256, device=args.device,
                            cache_dtype=torch.float32)
    eng_std.serve(prompts, budgets, max_batch=3)
    compressed, full = eng.cache_bytes(4), eng_std.cache_bytes(4)
    print(f"cache compression: {full / compressed:.1f}x "
          f"(compressed {compressed} B vs full {full} B at batch 4)")
    return {"prompts": prompts, "budgets": budgets, "outputs": outs,
            "completion_order": order, "mean_occupancy": occupancy,
            "outputs_static": outs_static, "outputs_chunked": outs_ck,
            "chunked_order": list(done_order),
            "prefill_tokens": stats.prefill_tokens,
            "prefill_forwards": stats.prefill_forwards,
            "cache_bytes": compressed, "cache_bytes_standard": full,
            "compression": full / compressed}


if __name__ == "__main__":
    main()

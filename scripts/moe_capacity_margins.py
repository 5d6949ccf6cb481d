#!/usr/bin/env python3
"""How close tests/test_torch_moe_capacity.py's preemption trace runs to a
flip, on the CPU (JAX and the port, both installed):

    PYTHONPATH=src python3 scripts/moe_capacity_margins.py [--draws 8]

Serves the trace of `test_preemption_matches_jax_when_rows_compete`
(qwen3-moe-30b-a3b SMOKE, capacity factor 1.0, fp32) through the JAX
engine and the port's, dense chunked and paged int8 chunked, and prints
whether the tokens agree, the smallest gap of the port's router between
the k-th and the (k+1)-th expert probability, and the smallest gap
between the two largest logits a sampled step saw. Then, for the paged
pool, it serves the trace again `--draws` times with the k/v entering the
int8 quantizer moved by one ulp at a seeded 1% of its elements (what
another CPU's float rounding does to the same matmuls) and prints how
many draws still give JAX's tokens.
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=8)
    args = ap.parse_args(argv)
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.serving.engine import ServingEngine as JaxEngine
    from repro_torch.core import cache as cache_lib
    from repro_torch.models import model as tmodel
    from repro_torch.models import moe as tmoe
    from repro_torch.serving import ServingEngine

    import test_torch_moe_capacity as cap
    from test_torch_slo import _requests
    torch.set_num_threads(1)
    cfg_j, params_j, cfg_t, params_t = cap.moe_setup(
        "qwen3-moe-30b-a3b", capacity_factor=cap.CAPACITY_FACTOR)
    prompts, budgets = _requests(8, seed=21)
    kw = dict(max_batch=2, priorities=[3, 3, 2, 2, 1, 1, 0, 0],
              arrival_chunks=[0, 0, 1, 1, 2, 2, 3, 3])
    gaps = {"route": [], "logits": []}
    route, sample = tmoe.route, tmodel.sample

    def rec_route(router, x, cfg):
        probs = torch.softmax(x.float() @ router, -1)
        s = torch.sort(probs, -1, descending=True).values
        gaps["route"].append(float((s[:, cfg.top_k - 1]
                                    - s[:, cfg.top_k]).min()))
        return route(router, x, cfg)

    def rec_sample(logits, temperature=0.0, generator=None):
        s = torch.sort(logits.float(), -1, descending=True).values
        gaps["logits"].append(float((s[..., 0] - s[..., 1]).min()))
        return sample(logits, temperature, generator)

    tmoe.route, tmodel.sample = rec_route, rec_sample
    out = {}
    for pool in ("dense-chunked", "paged-chunked"):
        ekw = dict(max_seq=cap.MAX_SEQ, decode_chunk=cap.DECODE_CHUNK,
                   **cap.POOLS[pool])
        want, _ = JaxEngine(params_j, cfg_j, cache_dtype=jnp.float32,
                            **ekw).serve(prompts, budgets,
                                         return_scheduler=True, **kw)
        eng = ServingEngine(params_t, cfg_t, device="cpu",
                            cache_dtype=torch.float32, **ekw)
        for k in gaps:
            gaps[k].clear()
        got, _ = eng.serve(prompts, budgets, return_scheduler=True, **kw)
        print(f"{pool}: tokens equal to JAX's {got == want}; router gap "
              f"min {min(gaps['route']):.3e}; top-2 logit gap min "
              f"{min(gaps['logits']):.3e}", flush=True)
        out[pool] = (eng, want)
    tmoe.route, tmodel.sample = route, sample
    eng, want = out["paged-chunked"]
    quantize = cache_lib.quantize_blockwise
    same = 0
    for d in range(args.draws):
        gen = torch.Generator().manual_seed(d)

        def nudged(x, axes, **qkw):
            pick = torch.rand(x.shape, generator=gen) < 0.01
            up = torch.nextafter(x, torch.full_like(x, float("inf")))
            return quantize(torch.where(pick, up, x), axes, **qkw)

        cache_lib.quantize_blockwise = nudged
        try:
            got, _ = eng.serve(prompts, budgets, return_scheduler=True, **kw)
        finally:
            cache_lib.quantize_blockwise = quantize
        same += got == want
        print(f"paged-chunked, k/v nudged one ulp (draw {d}): tokens equal "
              f"to JAX's {got == want}", flush=True)
    print(f"paged-chunked: {same} of {args.draws} nudged draws keep JAX's "
          f"tokens", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

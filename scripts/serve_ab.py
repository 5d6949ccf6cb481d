#!/usr/bin/env python3
"""Serve throughput of one source tree, for an A/B of two trees on one
card: [serve]'s model (qwen3-8b at full width, SERVE_LAYERS layers, random
bf16 weights from seed 0) serves [serve]'s 8 requests monolithic into the
dense pool and chunked (P = 512) into the paged int8 pool, one warm-up
serve and three timed serves each, and prints one line a serve:
``AB <tag> <mode> <tok/s> tok/s <seconds> s``.

It imports the package and chip_smoke.py of the current directory, so run
it from the root of each tree, the trees in turns on one card (parent,
change, change, parent), e.g. with a parent unpacked by `git archive`
into an ignored directory of the repo:

    for t in parent change change parent; do
        (cd "local/$t" && python3 "$REPO/scripts/serve_ab.py" "$t")
    done

Needs a CUDA card and nvcc (the kernels build on first use).
"""
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "src"))


def main(tag):
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    dev = torch.device("cuda")
    cs.build_phase()
    cfg = dataclasses.replace(get_config("qwen3-8b"),
                              num_layers=cs.SERVE_LAYERS)
    params, prompts = cs.serve_setup(dev, cfg)
    for mode, kw in (("dense", {}),
                     ("paged", dict(prefill_chunk=cs.SERVE_PREFILL_CHUNK,
                                    cache_format="paged",
                                    page_dtype=cs.SERVE_PAGE_DTYPE))):
        eng = cs.serve_engine(dev, cfg, params, **kw)
        eng.serve(prompts, cs.SERVE_BUDGETS, max_batch=4)
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = eng.serve(prompts, cs.SERVE_BUDGETS, max_batch=4)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            print(f"AB {tag} {mode} {sum(map(len, outs)) / dt:.2f} tok/s "
                  f"{dt:.3f} s", flush=True)
        del eng


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")

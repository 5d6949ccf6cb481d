#!/usr/bin/env python3
"""The spread, over parameter seeds, of the bf16 loss error of the kernel
route against the plain route: the loss term of chip_smoke's
[train-parity-bf16] and [train-mlm-parity-bf16] gates on one card.

    python3 scripts/bf16_loss_spread.py [--seeds 16]

Needs a CUDA card and nvcc. For each seed it draws the 2-layer fp32 model
of each gate (qwen3-8b at full width, B=1, S=1024, a causal batch; the
linformer-paper encoder at full width, B=2, S=512, an MLM batch; the
batches as chip_smoke makes them), casts it to bf16 and computes the loss
alone (no gradients) through the kernels in bf16, the plain reference in
bf16 and the plain reference in fp32; it prints each route's error against
fp32 and their ratio, kernels ÷ plain, then the median, extremes and the
count of seeds above chip_smoke's BF16_PARITY_FACTOR. chip_smoke draws
with seed 1.
"""
import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=16)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataState, SyntheticCorpus,
                                           make_causal_batch, make_mlm_batch)
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import flatten
    if not torch.cuda.is_available():
        print("bf16_loss_spread: needs a CUDA card", file=sys.stderr)
        return 1
    cs.log(cs.card_line())
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    enc = dataclasses.replace(get_config("linformer-paper"), num_layers=2,
                              dtype="float32")
    dec = dataclasses.replace(get_config("qwen3-8b"), num_layers=2,
                              dtype="float32")
    cases = (("qwen3-8b", dec, make_causal_batch(
                 SyntheticCorpus(dec.vocab_size, seed=0), DataState(0, 0),
                 batch=1, seq=cs.TRAIN_PARITY_SEQ)),
             ("linformer-paper", enc, make_mlm_batch(
                 SyntheticCorpus(enc.vocab_size, seed=0), DataState(0, 0),
                 batch=cs.MLM_PARITY["batch"], seq=cs.MLM_PARITY["seq"])))
    names = {"kernels bf16": "kernels", "plain bf16": "plain",
             "plain fp32": "fp32"}
    for name, cfg32, batch in cases:
        draws = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                 for b in cs.loss_draws(cfg32, batch)]
        grid = []                  # grid[seed][batch] = {route: loss}
        for seed in range(args.seeds):
            base = flatten(tmodel.init_params(cfg32, seed=seed, device=dev))
            grid.append([{names[r]: v for r, v in
                          cs.route_losses(cfg32, base, b).items()}
                         for b in draws])
            del base

        def ratio(cells):
            err = cs.bf16_loss_errors({
                r: [c[names[r]] for c in cells] for r in names})
            return err["kernels bf16"] / err["plain bf16"], err

        ratios, batched, gate = [], [], []
        for seed in range(args.seeds):
            one, err = ratio(grid[seed][:1])
            ratios.append(one)
            batched.append(ratio(grid[seed])[0])
            cells = [grid[(seed + k) % args.seeds][k]
                     for k in range(len(draws))]
            gate.append(ratio(cells)[0])
            cs.log(f"[bf16-loss-spread] {name} seed {seed}: loss fp32 "
                   f"{grid[seed][0]['fp32']:.6f}, error kernels bf16 "
                   f"{err['kernels bf16']:.3e}, plain bf16 "
                   f"{err['plain bf16']:.3e}, ratio {one:.3f}; over "
                   f"{len(draws)} batches {batched[-1]:.3f}; gate instance "
                   f"{seed} (seeds {seed}..{seed + len(draws) - 1}) "
                   f"{gate[-1]:.3f}")
        for what, r in (("one draw", ratios),
                        (f"{len(draws)} batches, one seed", batched),
                        (f"the gate, {len(draws)} draws", gate)):
            r = np.asarray(r)
            cs.log(f"[bf16-loss-spread] {name}, {what}: ratio median "
                   f"{np.median(r):.3f}, min {r.min():.3f}, max "
                   f"{r.max():.3f}, above {cs.BF16_PARITY_FACTOR:g}: "
                   f"{int((r > cs.BF16_PARITY_FACTOR).sum())} of {len(r)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

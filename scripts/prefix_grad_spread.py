#!/usr/bin/env python3
"""The spread, over input seeds, of the bf16 dq error of the prefix form's
VJP (kernel 4r forward, kernel 2's offset form backward): the dq term of
chip_smoke's [prefix-grad] gate, the route sequence-parallel training
runs on one card.

    python3 scripts/prefix_grad_spread.py [--seeds 16]

Needs a CUDA card and nvcc. For each seed it draws [prefix-grad]'s inputs
(B=4, H=32, Hkv=8, P=512, M=288, c=256, r=16, Dh=128, start blocks 0, 3,
7, 14, the cotangent from seed + 1; chip_smoke draws seed 70) and takes
dq through three routes: the kernels in bf16
(``kernels/ops.fused_chunk_prefill_attention``'s VJP), autograd through
the plain prefix form in bf16, and the same in fp32 on the upcast inputs.
It prints each bf16 route's max error against fp32 and their ratio,
kernels ÷ plain (a median above 1 would be a bias of the kernel route),
and the [prefix-grad] gate's terms for dq against the plain twin of
kernel 2 (``blockwise_causal_attn_bwd_plain``): the worst ratio of
|kernel − twin| to the bound GRAD_TOL·max(1, max|twin|) + 2^-7·|twin|
that chip_smoke held it to until the gate was restated in bf16 steps,
the ratio to the restated bound (one bf16 step of the twin's value in
place of 2^-7·|twin|: ``chip_smoke.check_grad_steps``), and the largest
distance in bf16 steps where a step exceeds the GRAD_TOL slack. Then the
median, extremes and counts.
"""
import argparse
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
    from repro_torch.core import causal
    from repro_torch.kernels import blockwise_causal_attn as bca
    from repro_torch.kernels import ops
    if not torch.cuda.is_available():
        print("prefix_grad_spread: needs a CUDA card", file=sys.stderr)
        return 1
    cs.log(cs.card_line())
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    shape, start, M = cs.PREFIX_SHAPES["full"]
    B, H, Hkv, P, c, r, Dh = shape
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    bf16 = torch.bfloat16
    ratios, gate, restated, steps = [], [], [], []
    for seed in range(70, 70 + args.seeds):
        qk, kk, vk, ck, cv, sb = cs.prefix_inputs(shape, start, M, bf16, dev,
                                                  seed=seed)
        ck, cv = ck.to(bf16), cv.to(bf16)
        model = [x.movedim(1, 2).contiguous() for x in (qk, kk, vk, ck, cv)]
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        do = torch.randn(model[0].shape, generator=g, device=dev).to(bf16)

        def dq_of(fn, xs, cot):
            leaves = [x.detach().requires_grad_() for x in xs]
            return torch.autograd.grad(fn(*leaves, sb, **kw), leaves[0],
                                       cot)[0].float()

        dq_k = dq_of(ops.fused_chunk_prefill_attention, model, do)
        dq_p = dq_of(causal.blockwise_causal_prefix_attention, model, do)
        dq_32 = dq_of(causal.blockwise_causal_prefix_attention,
                      [x.float() for x in model], do.float())
        _, m, d = bca.blockwise_causal_attn_plain(
            qk, kk, vk, ck, cv, start_blocks=sb, return_residuals=True, **kw)
        twin = bca.blockwise_causal_attn_bwd_plain(
            qk, kk, vk, ck, cv, m, d, do.movedim(1, 2), start_blocks=sb,
            **kw)[0].movedim(1, 2)
        ek = (dq_k - dq_32).abs().max().item()
        ep = (dq_p - dq_32).abs().max().item()
        ratios.append(ek / ep)
        tw = twin.float()
        diff = (dq_k - tw).abs()
        slack = cs.GRAD_TOL * max(1.0, tw.abs().max().item())
        step = cs.bf16_step(tw)
        gate.append((diff / (slack + 2 ** -7 * tw.abs())).max().item())
        restated.append((diff / (slack + step)).max().item())
        big = step > slack
        steps.append(int((diff[big] / step[big]).round().max().item()))
        cs.log(f"[prefix-grad-spread] seed {seed}: dq error against fp32, "
               f"kernels bf16 {ek:.3e}, plain bf16 {ep:.3e}, ratio "
               f"{ek / ep:.3f}; against the twin {gate[-1]:.3f} of the "
               f"2^-7 gate, {restated[-1]:.3f} of the one-step gate, "
               f"{steps[-1]} bf16 step(s) apart at most")
        del model, do, dq_k, dq_p, dq_32, twin, tw, diff, step, m, d
    r_, g_, s_ = np.asarray(ratios), np.asarray(gate), np.asarray(restated)
    cs.log(f"[prefix-grad-spread] {len(r_)} seeds: ratio kernels ÷ plain "
           f"median {np.median(r_):.3f}, min {r_.min():.3f}, max "
           f"{r_.max():.3f}, above 1: {int((r_ > 1).sum())}; 2^-7 gate "
           f"median {np.median(g_):.3f}, max {g_.max():.3f}; one-step gate "
           f"median {np.median(s_):.3f}, max {s_.max():.3f}; step distance "
           f"to the twin at most {max(steps)} (seeds at 1 step: "
           f"{steps.count(1)}, at 0: {steps.count(0)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Design variants of the tensor-core backward (kernel 2 in bf16), timed on
one card.

    python3 scripts/bwd_variants.py

Needs a CUDA card and nvcc. Builds `src/repro_torch/csrc/blockwise_causal_attn_bwd.cu`
as it stands and in variants made by replacing one passage of it (each
replacement must match, or the script stops), each into its own library
with `nvcc` (all at once, as scripts/prefix_variants.py does), and times
kernel 2 (`blockwise_causal_attn_bwd`) in bf16 at the train step's shapes
(chip_smoke.TRAIN_TIME_SHAPE) by CUDA-graph replay over inputs rotated
through more than the L2 cache, in turns (every variant, then every
variant in reverse order). Each variant's worst error against the plain
twin is printed beside its times, as a share of chip_smoke's GRAD_TOL
bound; the diagnostic variants compute garbage on purpose:

- one_term: P and dS as one bf16 term (hi) instead of two (the price of
  the split, and the error it avoids);
- split_256 / split_1024: rows of a slot tile split every 256 or 1024
  rows instead of 512 (the scratch is sized to match);
- row_step_64: the dk/dv kernel walks 64 query rows a step instead of 32;
- dq_only: only the dq kernel (delta pass and dq) is launched;
- dkdv_only: only the dk/dv kernel and the reduction are launched (delta
  unset);
- no_delta_pass: the dq kernel skips its delta pass (delta 0).

Prints the card line, each variant's -Xptxas -v registers of the dq and
dk/dv kernels at Dh = 128, one line per variant and round, and a last JSON
line {"variants": {name: {"ms": [...], "worst": x}}}.
"""
import json
import re
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from prefix_variants import build_variants  # noqa: E402

SOURCE = "blockwise_causal_attn_bwd.cu"
LO_MMAS = ("    mma::mma_bf16_16816(acc[2 * dp], lo, f[0], f[1]);\n",
           "    mma::mma_bf16_16816(acc[2 * dp + 1], lo, f[2], f[3]);\n")
SPLIT = "constexpr int kSplitRows = 512;"
DQ_LAUNCH = ("  dq_kernel<<<static_cast<unsigned>(dq_blocks), tcb::kThreads, "
             "L::kDqBytes, stream>>>(p);\n")
KV_LAUNCH = ("  kv_kernel<<<static_cast<unsigned>(kv_blocks), tcb::kThreads, "
             "L::kDkdvBytes, stream>>>(p);\n")

VARIANTS = {
    "kernel": [],
    "one_term": [(x, "") for x in LO_MMAS],
    "split_256": [(SPLIT, SPLIT.replace("512", "256"))],
    "split_1024": [(SPLIT, SPLIT.replace("512", "1024"))],
    "row_step_64": [("constexpr int kRowStep = 32;",
                     "constexpr int kRowStep = 64;")],
    "dq_only": [(DQ_LAUNCH + "  err = cudaGetLastError();\n"
                 "  if (err != cudaSuccess) return err;\n",
                 DQ_LAUNCH + "  return cudaGetLastError();\n")],
    "dkdv_only": [(DQ_LAUNCH, "")],
    "no_delta_pass": [("  for (int w = 0; w < 2 * n_items; ++w) {",
                       "  for (int w = n_items; w < 2 * n_items; ++w) {")],
}
SPLIT_ROWS = {"split_256": 256, "split_1024": 1024}


def registers(log, kernel):
    """{Dh: registers} of `kernel`'s instantiations in a -Xptxas -v log."""
    out, lines = {}, log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line:
            dh = int(re.search(kernel + r"ILi(\d+)E", line).group(1))
            tail = " ".join(lines[i + 1:i + 4])
            out[dh] = int(re.search(r"Used (\d+) registers", tail).group(1))
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("bwd_variants: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT.parent / "src"))
    sys.path.insert(0, str(ROOT.parent))
    import chip_smoke as cs
    from repro_torch.kernels import blockwise_causal_attn as bca
    from repro_torch.kernels import common
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    print(cs.card_line(), flush=True)
    B, H, Hkv, S, c, r, Dh = cs.TRAIN_TIME_SHAPE
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    sets = []
    for i in range(2):                            # 2 x ~100 MB > 50 MB L2
        xs = cs.bca_inputs(B, H, Hkv, S, c, r, Dh, bf16, dev, seed=30 + i)
        _, m, d = bca.blockwise_causal_attn(*xs, return_residuals=True, **kw)
        g = torch.Generator(device=dev).manual_seed(40 + i)
        do = torch.randn(xs[0].shape, generator=g, device=dev).to(bf16)
        sets.append((*xs, m, d, do))
    ref = bca.blockwise_causal_attn_bwd_plain(*sets[0], **kw)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    split_rows = common.BCA_BWD_SPLIT_ROWS
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp, SOURCE, VARIANTS, ("bca_backward",))
        for name, kl in libs.items():
            print(f"{name:14s} registers at Dh = 128: dq "
                  f"{registers(kl.log, 'bca_bwd_dq_mma_kernel')[128]}, dk/dv "
                  f"{registers(kl.log, 'bca_bwd_dkdv_mma_kernel')[128]}",
                  flush=True)
        res = {name: {"ms": [], "worst": None} for name in libs}
        for names in (list(libs), list(libs)[::-1]):
            for name in names:
                kl = libs[name]
                common.BCA_BWD_SPLIT_ROWS = SPLIT_ROWS.get(name, split_rows)

                def run(i, kl=kl):
                    return bca.launch_bwd(kl, *sets[i], stream=stream(), **kw)

                got = run(0)
                torch.cuda.synchronize()
                worst = max(((a.float() - b.float()).abs().max().item()
                             / (cs.GRAD_TOL * max(1.0, b.abs().max().item())))
                            for a, b in zip(got[1:], ref[1:]))
                ms = cs.time_graph_ms(run, 2, iters=10)
                res[name]["ms"].append(ms)
                res[name]["worst"] = worst
                print(f"{name:14s} {ms:.4f} ms, worst dk/dv error {worst:.3f} "
                      f"of the bound", flush=True)
                common.BCA_BWD_SPLIT_ROWS = split_rows
    print(json.dumps({"variants": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""chip_smoke.py's multi-GPU phases alone, on one CUDA card:

    python3 scripts/mesh_smoke.py

Builds the kernels ([build]), starts [launch] (torchrun, 2 gloo ranks,
the SMOKE config) and runs the 4-rank gloo spawn of [mesh], [mesh-moe],
[mesh-train], [mesh-train-compressed], [mesh-elastic] and [mesh-serve]
beside it, then the world-size-1 NCCL leg, with chip_smoke's gates and
log lines: a check of those phases in about five minutes instead of the
whole run's ten or more. Needs the card (chip_smoke's phases raise
without one).
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def main():
    import torch
    if not torch.cuda.is_available():
        print("mesh_smoke: this script needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(cs.card_line())
    cs.build_phase()

    def lap(name):
        cs.log(f"[wall] {name}: {time.perf_counter() - t0:.1f} s into the "
               "run")

    lap("build")
    cs.mesh_and_launch_phases(dev, lap)
    cs.log(f"[done] {time.perf_counter() - t0:.1f} s on {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

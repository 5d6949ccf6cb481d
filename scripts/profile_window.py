#!/usr/bin/env python3
"""Why chip_smoke's profiles idle inside the recorded window: the
launches of kernels 5 and 6 that torch.profiler records against their
launch counters, with and without host idle around the recorded step.

    python3 scripts/profile_window.py [--reps 8] [--gaps 0,0.001,0.005,0.05]

Needs a CUDA card and nvcc. Drives [train-mlm]'s profiled forward
(linformer-paper CONFIG at full width and depth, bf16, random weights from
seed 0, B = 32, S = 512, random tokens, torch.no_grad) through
chip_smoke.profile_kernels at each gap in turn, `reps` rounds. For each
profile it prints the launches of kernels 5 and 6 that the profiler kept
against their counters, and from the Chrome trace:

- lead: the first kept kernel's start minus the recorded step's start
  (the ProfilerStep annotation), ms;
- skew: the least (kernel start - its launch call's start) over the kept
  kernels, ms, matched by correlation id. A kernel cannot start before it
  is launched, so a negative skew is an offset between the clock of the
  device timestamps and the host's;
- launch_lead: the first launch call minus the step's start, ms;
- orphans: launch calls in the trace whose kernel is not in it (dropped
  by the profiler), and how many of them precede the first kept kernel;
- skew_at: the kernel with the least skew, and its place among the kept
  kernels in start order.

Run it in a process that has run for a while too (--age SECONDS of
forwards before the first profile): chip_smoke's profiles come minutes
into its run. Last line: JSON {"card": ..., "runs": [{gap, rep, seen,
counted, lead_ms, skew_ms, launch_lead_ms, orphans, orphans_first,
skew_at}, ...]}.
"""
import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def trace_times(path):
    """{lead_ms, skew_ms, launch_lead_ms, orphans, orphans_first, skew_at}
    from a Chrome trace (see the module docstring); None where the trace
    lacks the events."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    steps = [e["ts"] for e in events
             if e.get("name", "").startswith("ProfilerStep#")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime"
                and "Launch" in e.get("name", "")
                and "correlation" in e.get("args", {})}
    out = dict(lead_ms=None, skew_ms=None, launch_lead_ms=None,
               orphans=None, orphans_first=None, skew_at=None)
    if not steps or not kernels:
        return out
    step0 = min(steps)
    kernels.sort(key=lambda k: k["ts"])
    out["lead_ms"] = (kernels[0]["ts"] - step0) / 1e3
    seen = {k.get("args", {}).get("correlation") for k in kernels}
    orphans = [c for c in launches if c not in seen]
    out["orphans"] = len(orphans)
    out["orphans_first"] = sum(launches[c] < kernels[0]["ts"]
                               for c in orphans)
    skews = [(k["ts"] - launches[k["args"]["correlation"]], i, k["name"])
             for i, k in enumerate(kernels)
             if k.get("args", {}).get("correlation") in launches]
    if skews:
        skew, at, name = min(skews)
        out["skew_ms"] = skew / 1e3
        out["skew_at"] = f"{at} of {len(kernels)}: {name[:60]}"
    if launches:
        out["launch_lead_ms"] = (min(launches.values()) - step0) / 1e3
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("profile_window: needs a CUDA card", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--gaps", default="0,0.001,0.005,0.05")
    ap.add_argument("--age", type=float, default=0.0)
    args = ap.parse_args()
    gaps = [float(g) for g in args.gaps.split(",")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import model as tmodel
    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    cfg = get_config("linformer-paper")
    params = tmodel.init_params(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(4, cfg.vocab_size,
                         (cs.MLM_RUN["batch"], cs.MLM_RUN["seq"]),
                         generator=g, device=dev)

    def infer():
        with torch.no_grad():
            return tmodel.forward(params, cfg, {"tokens": toks})[0]

    t0 = time.perf_counter()
    infer()
    while time.perf_counter() - t0 < args.age:
        infer()
    torch.cuda.synchronize()
    runs = []
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        trace = os.path.join(tmp, "trace.json")
        for rep in range(args.reps):
            for gap in gaps:
                kernels, counted, _ = cs.profile_kernels(infer, gap=gap,
                                                         trace=trace)
                seen = cs.profiled_launches(kernels)
                run = dict(gap=gap, rep=rep, seen=seen,
                           counted={k: counted[k] for k in seen},
                           **trace_times(trace))
                runs.append(run)
                print(f"gap {gap:g} s rep {rep}: " + ", ".join(
                    f"{k} {v}" for k, v in run.items()
                    if k not in ("gap", "rep")), flush=True)
    for gap in gaps:
        mine = [r for r in runs if r["gap"] == gap]
        short = sum(r["seen"] != r["counted"] for r in mine)
        skews = [r["skew_ms"] for r in mine if r["skew_ms"] is not None]
        orph = sum(r["orphans"] or 0 for r in mine)
        print(f"gap {gap:g} s: {short} of {len(mine)} profiles short, "
              f"{orph} orphan launches; skew "
              f"{min(skews) if skews else None} .. "
              f"{max(skews) if skews else None} ms; skew below -0.1 ms in "
              f"{sum(x < -0.1 for x in skews)}", flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

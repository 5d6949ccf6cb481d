#!/usr/bin/env python3
"""PERF.md's dry-run table from the records `python -m
repro_torch.launch.dryrun --all` writes under build/dryrun/:

    python3 scripts/dryrun_table.py [--before DIR] [--dir DIR]

One row an arch, one column a shape, each cell "peak GiB a device,
FLOPs a device, dominant roofline term (C compute, M memory, X
collective)" on the 16 × 16 mesh, then on 2 × 16 × 16; with --before
(the records of another tree, e.g. a `git archive` of the parent run the
same way) each number as before → after. Then each train_4k cell's
useful-FLOPs ratio and its model-dim collective bytes by op. The records
are figures from FakeTensors on the CPU, not measurements.
"""
import argparse
import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DOM = {"compute_s": "C", "memory_s": "M", "collective_s": "X"}


def load(d):
    out = {}
    for path in glob.glob(os.path.join(d, "*.json")):
        with open(path) as fh:
            r = json.load(fh)
        if not r.get("tag"):
            out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def cell(r):
    return (f"{r['peak_bytes'] / 2 ** 30:.0f} GiB "
            f"{r['flops_per_device']:.1e} {DOM[r['dominant']]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=os.path.join(ROOT, "build", "dryrun"))
    ap.add_argument("--before", default=None)
    args = ap.parse_args(argv)
    after = load(args.dir)
    before = load(args.before) if args.before else {}
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.dryrun import ARCH_IDS
    archs = [a for a in ARCH_IDS if any(k[0] == a for k in after)]
    out = ["| arch | " + " | ".join(SHAPES) + " |",
           "| --- |" + " --- |" * len(SHAPES)]
    for arch in archs:
        row = []
        for shape in SHAPES:
            parts = []
            for mesh in ("16x16", "2x16x16"):
                r = after.get((arch, shape, mesh))
                if r is None:
                    parts.append("—")
                    continue
                b = before.get((arch, shape, mesh))
                parts.append(cell(r) if b is None
                             else f"{cell(b)} → {cell(r)}")
            row.append(" / ".join(parts))
        out.append(f"| {arch} | " + " | ".join(row) + " |")
    out.append("")
    for (arch, shape, mesh), r in sorted(after.items()):
        if shape != "train_4k" or mesh != "16x16":
            continue
        b = before.get((arch, shape, mesh))
        model = {k: v for k, v in r.get("collective_bytes_by_op_dim",
                                        {}).items() if k.endswith("/model")}
        line = (f"{arch}: useful {r['useful_flops_ratio']:.3f}, collective "
                f"{r['roofline']['collective_s']:.3f} s, model-dim bytes "
                f"{ {k: round(v / 1e9, 2) for k, v in model.items()} } GB")
        if b is not None:
            was = b["collectives_by_dim"].get("model", {}).get("bytes", 0)
            line += (f" (before: useful {b['useful_flops_ratio']:.3f}, "
                     f"collective {b['roofline']['collective_s']:.3f} s, "
                     f"model dim {was / 1e9:.2f} GB)")
        out.append(line)
    sys.stdout.write("\n".join(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

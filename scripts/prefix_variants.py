#!/usr/bin/env python3
"""Design variants of the tensor-core prefix kernel, timed on one card.

    python3 scripts/prefix_variants.py

Needs a CUDA card and nvcc. Builds `src/repro_torch/csrc/blockwise_causal_attn.cu`
as it stands and in variants made by replacing one passage of it (each
replacement must match, or the script stops), each into its own library
with `nvcc` (all at once), and times kernels 4 (`blockwise_causal_prefix_attn`)
and 8 (`blockwise_causal_prefix_attn_q`, int8 slots) in bf16 at the chunked
serve's chunk forward (chip_smoke.PREFIX_SHAPES["full"]) by CUDA-graph
replay over inputs rotated through more than the L2 cache, in turns (every
variant, then every variant in reverse order). Each variant's error against
the plain twin is printed beside its times; the two diagnostic variants
compute garbage on purpose:

- heavy_last: the query tiles of a kv head in their natural order, not the
  heaviest (last) first;
- one_head: one query head a block for every group (two stages), where the
  kernel takes two heads of an even group (three stages);
- two_stages / four_stages: two or four tile buffers for two heads a block;
- loads_only: every tile loaded and waited for, no product computed;
- compute_only: only the prologue's tiles loaded, every product computed
  (on stale tiles).

Prints the card line, one line per variant and round, and a last JSON line
{"variants": {name: {"k4_ms": [...], "k8_ms": [...]}}}.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = "blockwise_causal_attn.cu"
HEADS2 = ("if ((p.H / p.Hkv) % 2 == 0) return "
          "dispatch_prefix_head_dim<S, 2>(p, B, Dh, stream);")
STAGES = ("__host__ __device__ constexpr int stages(int heads) "
          "{ return heads == 2 ? 3 : 2; }")


def _stages(two_heads):
    return [(STAGES, STAGES.replace("heads == 2 ? 3", f"heads == 2 ? "
                                    f"{two_heads}"))]


VARIANTS = {
    "kernel": [],
    "heavy_last": [("const int qt = nq - 1 - id % nq;",
                    "const int qt = id % nq;")],
    "one_head": [(HEADS2, HEADS2.replace("(p.H / p.Hkv) % 2 == 0",
                                         "false"))],
    "two_stages": _stages(2),
    "four_stages": _stages(4),
    "loads_only": [("    if (!active) continue;\n    // the tile's",
                    "    if (true) continue;\n    // the tile's")],
    "compute_only": [("    if (w < items) {\n      const int st = w % kStages;",
                      "    if (w < items && w < kStages - 1) {\n"
                      "      const int st = w % kStages;")],
}


def build_variants(tmp, source=SOURCE, variants=VARIANTS,
                   fns=("bca_forward",)):
    """{name: KernelLibrary} of every variant of `source` (one library each,
    binding the exported `fns`), built in parallel, -Xptxas -v in the log."""
    from repro_torch.kernels import build
    nvcc = build.find_nvcc()
    procs = {}
    for name, subs in variants.items():
        d = Path(tmp) / name
        shutil.copytree(build.CSRC, d)
        text = (d / source).read_text()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: passage not in {source}: {old!r}")
            text = text.replace(old, new)
        (d / source).write_text(text)
        so = d / "lib.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             str(d / source), str(d / "runtime.cu"), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out}")
        lib = ctypes.CDLL(str(so))
        for fn in (*fns, "repro_torch_error_string"):
            f = getattr(lib, fn)
            f.restype, f.argtypes = build.SIGNATURES[fn]
        libs[name] = build.KernelLibrary(lib=lib, path=so, build_seconds=0.0,
                                         log=out)
    return libs


def main():
    import torch
    if not torch.cuda.is_available():
        print("prefix_variants: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import blockwise_causal_attn as bca
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    print(cs.card_line(), flush=True)
    shape, start, M = cs.PREFIX_SHAPES["full"]
    c, r, Dh = shape[4:]
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    sets, qsets = [], []
    for i in range(4):                            # 4 x ~30 MB > 50 MB L2
        q, k, v, ck, cv, sb = cs.prefix_inputs(shape, start, M, bf16, dev,
                                               seed=50 + i)
        sets.append((q, k, v, ck.to(bf16), cv.to(bf16), sb))
        (ckq, cks), (cvq, cvs) = (cs.quantized(x, "int8") for x in (ck, cv))
        qsets.append((q, k, v, ckq, cvq, cks, cvs, sb))
    ref = bca.blockwise_causal_attn_plain(*sets[0][:5],
                                          start_blocks=sets[0][5], **kw)
    refq = bca.blockwise_causal_prefix_attn_q_plain(*qsets[0], **kw)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        times = {name: {"k4_ms": [], "k8_ms": []} for name in libs}
        for names in (list(libs), list(libs)[::-1]):
            for name in names:
                kl = libs[name]

                def k4(i, kl=kl):
                    return bca.launch(kl, *sets[i][:5],
                                      start_blocks=sets[i][5],
                                      stream=stream(), **kw)

                def k8(i, kl=kl):
                    q, k, v, ckq, cvq, cks, cvs, sb = qsets[i]
                    return bca.launch(kl, q, k, v, ckq, cvq, start_blocks=sb,
                                      kbar_scale=cks, vbar_scale=cvs,
                                      stream=stream(), **kw)

                e4 = (k4(0).float() - ref.float()).abs().max().item()
                e8 = (k8(0).float() - refq.float()).abs().max().item()
                t4, t8 = cs.time_graph_ms(k4, 4), cs.time_graph_ms(k8, 4)
                times[name]["k4_ms"].append(t4)
                times[name]["k8_ms"].append(t8)
                print(f"{name:14s} kernel 4 {t4:.4f} ms (error {e4:.3e}), "
                      f"kernel 8 {t8:.4f} ms (error {e8:.3e})", flush=True)
    print(json.dumps({"variants": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

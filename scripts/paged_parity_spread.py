#!/usr/bin/env python3
"""How far the paged pools' chunk-forward logits of the kernel route fall
from the plain reference route's, over parameter seeds: the paged legs of
chip_smoke's [parity] and [serve-dense-parity] on one card, with the
quantized codes the two routes disagree on.

    python3 scripts/paged_parity_spread.py [--seeds 8] [--archs qwen3-8b,...]

Needs a CUDA card and nvcc. For each config (2 layers at full width, fp32,
the parity phases' prompts of c + 5 and 2c + 9 tokens, their first
512-token chunk) and each seed it runs one chunk forward into a fresh
int8 and fp8 paged pool through the kernels (backend "auto") and through
the plain reference, and prints the largest |logits difference| beside
chip_smoke's LOGITS_TOL and, per layer, the codes of the written pages
(`page_k`, `page_v`) and rings (`raw_k_q`, `raw_v_q`) that differ between
the two pools. Layer 0 sees the same inputs in both routes; a later
layer's inputs differ by the routes' rounding, and a value that falls on
the other side of a rounding boundary takes another code. Beside it, the
comparison chip_smoke's gate makes (`chip_smoke.paged_layer_parity`):
the same chunk forward a layer at a time, both routes on shared inputs
and codes, its codes written differently, block errors and logits
difference, and the count of seeds where that gate fails. chip_smoke
draws with seed 1.
"""
import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

CODES = ("page_k", "page_v", "raw_k_q", "raw_v_q")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--archs", default="qwen3-8b,qwen3-14b,nemotron-4-15b,"
                                       "qwen1.5-110b")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import model as tmodel
    from repro_torch.serving import ServingEngine
    if not torch.cuda.is_available():
        print("paged_parity_spread: needs a CUDA card", file=sys.stderr)
        return 1
    cs.log(cs.card_line())
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    P = cs.SERVE_PREFILL_CHUNK
    for arch in args.archs.split(","):
        cfg2 = dataclasses.replace(get_config(arch), num_layers=2,
                                   dtype="float32")
        c = cfg2.attention.linformer.block_size
        rng = np.random.default_rng(1)
        prompts = [list(map(int, rng.integers(4, cfg2.vocab_size, n)))
                   for n in (c + 5, 2 * c + 9)]
        toks, n_valid = cs.chunk_rows(prompts, P, c)
        over = {"int8": 0, "fp8": 0}
        gate = {"int8": 0, "fp8": 0}
        for seed in range(args.seeds):
            params = tmodel.init_params(cfg2, seed=seed, device=dev)
            for pd in ("int8", "fp8"):
                engines = {b: ServingEngine(
                    params, cfg2, max_seq=4096, device=dev,
                    cache_dtype=torch.float32, decode_chunk=16,
                    attention_backend=b, prefill_chunk=P,
                    cache_format="paged", page_dtype=pd)
                    for b in ("auto", "reference")}
                rep = cs.paged_layer_parity(engines, params, cfg2, toks,
                                            n_valid)
                del engines
                fails = bool(any(rep["flips"]) or rep["logits"] > cs.LOGITS_TOL
                             or any(e > cs.LOGITS_TOL for e in rep["errs"]))
                gate[pd] += fails
                cs.log(f"[paged-parity-spread] {arch} seed {seed} {pd}, a "
                       f"layer at a time on shared inputs and codes: codes "
                       f"differing by layer {rep['flips']}, block errors "
                       f"{[f'{e:.2e}' for e in rep['errs']]}, logits "
                       f"{rep['logits']:.3e}; gate fails: {fails}")
                out = {}
                for backend in ("auto", "reference"):
                    eng = ServingEngine(
                        params, cfg2, max_seq=4096, device=dev,
                        cache_dtype=torch.float32, decode_chunk=16,
                        attention_backend=backend, prefill_chunk=P,
                        cache_format="paged", page_dtype=pd)
                    pool = eng.init_pool_cache(2)
                    maxp = eng.max_pages_per_row()
                    for row in range(2):
                        eng.write_table_row(
                            pool, row, range(row * maxp, (row + 1) * maxp))
                    _, lg = eng.pool_prefill_chunk(pool, [0, 1], toks,
                                                   n_valid, pad_to=2)
                    out[backend] = (lg.float(), pool)
                    del eng
                dl = (out["auto"][0] - out["reference"][0]).abs().max()
                dl = dl.item()
                flips = [sum(int((out["auto"][1][k][i]
                                  != out["reference"][1][k][i]).sum())
                             for k in CODES)
                         for i in range(cfg2.num_layers)]
                over[pd] += dl > cs.LOGITS_TOL
                cs.log(f"[paged-parity-spread] {arch} seed {seed} {pd}: "
                       f"logits max |auto - reference| {dl:.3e} (LOGITS_TOL "
                       f"{cs.LOGITS_TOL:g}); codes differing by layer "
                       f"{flips}")
                del out
            del params
            torch.cuda.empty_cache()
        cs.log(f"[paged-parity-spread] {arch}: seeds over LOGITS_TOL, two "
               f"independent forwards: int8 {over['int8']}, fp8 "
               f"{over['fp8']} of {args.seeds}; the layer-at-a-time gate "
               f"fails: int8 {gate['int8']}, fp8 {gate['fp8']} of "
               f"{args.seeds}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) on any
error; none catches its own failure:

1. require a CUDA card and print `nvidia-smi`'s name and power limit;
2. build the CUDA kernels from src/repro_torch/csrc (one nvcc per source),
   printing the build time and the -Xptxas -v register / shared-memory lines;
3. hold each kernel against its plain PyTorch version on the card, in fp32
   and bf16, at a small edge-case shape and at full width (qwen3-8b:
   c=256, r=16, Dh=128, H=32, Hkv=8; prefill S=1024; decode B=4, M=256);
4. time each kernel at full width in bf16 with CUDA events (inputs rotated
   through more than the 50 MB L2 cache), beside its plain version, one
   PyTorch library call computing the same function, and the least time
   the card could take (bytes over 3.35 TB/s or flops over 989 TFLOP/s);
5. serve 8 requests through full-width, 36-layer qwen3-8b (random bf16
   weights from a seeded generator, bf16 cache, max_seq 4096, max_batch 4,
   decode_chunk 16), prompts of k·256+j tokens, with the kernels' launch
   counters reset just before and read just after;
6. at full width with 2 layers in fp32, serve 2 requests with the kernels
   (backend "auto") and with the plain reference: prefill logits within
   the stated tolerance, first 16 greedy tokens identical.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
# Kernel vs plain version. fp32: 1e-4 absolute (summation order). bf16:
# |kernel - plain| <= 2^-8·max|v| + 2^-7·|plain| elementwise: the plain
# version rounds each probability to bf16 (relative 2^-9) before the value
# product, where the kernel keeps it in fp32, and each output is rounded
# once to bf16 (relative 2^-8).
FP32_TOL = 1e-4
LOGITS_TOL = 2e-3      # 2-layer fp32 prefill logits, kernels vs reference


def log(msg):
    print(msg, flush=True)


def time_ms(fn, n_sets, iters=30, warmup=3):
    """Mean device time of fn(i) over `iters` calls, cycling through
    `n_sets` input sets, by CUDA events around the whole run."""
    import torch
    for i in range(warmup):
        fn(i % n_sets)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_sets)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_kernels(fn):
    """Run fn once under torch.profiler; return [(kernel name, launches,
    device seconds)] sorted by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = [(e.key, e.count, e.self_device_time_total * 1e-6)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    return sorted(out, key=lambda x: -x[2])


def bca_inputs(B, H, Hkv, S, c, r, Dh, dtype, dev, seed):
    import torch
    from repro_torch.core.causal import compress_blocks
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, Dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
    E = (torch.randn(c, r, generator=g, device=dev) * r ** -0.5).to(dtype)
    nb = S // c
    kbar = compress_blocks(k.reshape(B, nb, c, Hkv, Dh), E)
    vbar = compress_blocks(v.reshape(B, nb, c, Hkv, Dh), E)
    tk = lambda x: x.movedim(2, 1)  # noqa: E731  model -> kernel layout
    return (tk(q), tk(k), tk(v), tk(kbar.reshape(B, nb * r, Hkv, Dh)),
            tk(vbar.reshape(B, nb * r, Hkv, Dh)))


def decode_inputs(B, Hkv, G, c, M, r, Dh, dtype, dev, seed, t):
    """Decode operands for rows at positions t (list): pos = t % c, blk =
    t // c select the visible ring entries and slots."""
    import torch
    from repro_torch.core.causal import NEG_INF
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Hkv, G, Dh, generator=g, device=dev).to(dtype)
    kv = [torch.randn(B, n, Hkv, Dh, generator=g,
                      device=dev).to(dtype).movedim(2, 1)
          for n in (c, c, M, M)]
    t = torch.tensor(t, device=dev)
    bl = torch.where(torch.arange(c, device=dev)[None] <= (t % c)[:, None],
                     0.0, NEG_INF).float()
    bg = torch.where(torch.arange(M, device=dev)[None]
                     < (t // c * r)[:, None], 0.0, NEG_INF).float()
    return (q, *kv, bl, bg)


def check(name, out, ref, dtype, values):
    """Hold a kernel's output against its plain version (see FP32_TOL);
    `values` are the value operands, whose magnitude scales the bf16
    bound. Returns the max absolute error."""
    import torch
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    if dtype == torch.float32:
        bound = torch.full_like(diff, FP32_TOL)
    else:
        vmax = max(v.float().abs().max().item() for v in values)
        bound = 2 ** -8 * vmax + 2 ** -7 * ref.float().abs()
    worst = (diff / bound).max().item()
    log(f"  {name} {str(dtype)[6:]}: max |kernel - plain| = {err:.3e}, "
        f"{worst:.2f} of its bound")
    if not worst <= 1.0:
        raise AssertionError(f"{name} {dtype}: error {err} beyond its bound")
    return err


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import numpy as np
    import torch.nn.functional as Fn
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import EOS
    from repro_torch.kernels import blockwise_causal_attn as bca
    from repro_torch.kernels import build
    from repro_torch.kernels import linformer_attn as la
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import param_bytes
    from repro_torch.serving import ServingEngine

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # -- 2. build ---------------------------------------------------------
    kl = build.library()
    log(f"[build] {kl.path.name}: {kl.build_seconds:.1f} s "
        f"({len(build.sources())} nvcc processes in parallel)")
    for line in kl.log.splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line or line.startswith("=="):
            log(f"  {line.strip()}")

    # -- 3. kernels against their plain versions --------------------------
    log("[check] kernels vs plain versions")
    errs = {}
    bca_shapes = {"small": (2, 4, 2, 64, 16, 4, 16),
                  "full": (1, 32, 8, 1024, 256, 16, 128)}
    dec_shapes = {"small": ((4, 2, 2, 16, 24, 4, 16), [0, 15, 16 + 7, 95]),
                  "full": ((4, 8, 4, 256, 256, 16, 128),
                           [0, 255, 256 * 5 + 100, 256 * 15 + 255])}
    for dtype in (torch.float32, torch.bfloat16):
        for size, (B, H, Hkv, S, c, r, Dh) in bca_shapes.items():
            args = bca_inputs(B, H, Hkv, S, c, r, Dh, dtype, dev, seed=1)
            kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
            out = bca.blockwise_causal_attn(*args, **kw)
            torch.cuda.synchronize()
            errs["bca", size, dtype] = check(
                f"blockwise_causal_attn {size}", out,
                bca.blockwise_causal_attn_plain(*args, **kw), dtype,
                (args[2], args[4]))
        for size, ((B, Hkv, G, c, M, r, Dh), t) in dec_shapes.items():
            args = decode_inputs(B, Hkv, G, c, M, r, Dh, dtype, dev, 2, t)
            out = la.decode_attn(*args, scale=Dh ** -0.5)
            torch.cuda.synchronize()
            errs["dec", size, dtype] = check(
                f"decode_attn {size}", out,
                la.decode_attn_plain(*args, scale=Dh ** -0.5), dtype,
                (args[2], args[4]))

    # -- 4. timing at full width, bf16 ------------------------------------
    log("[time] full width, bf16, L2-cold inputs")
    bf16 = torch.bfloat16
    records = []
    B, H, Hkv, S, c, r, Dh = bca_shapes["full"]
    n_sets = 4                                    # 4 x ~22 MB > 50 MB L2
    sets = [bca_inputs(B, H, Hkv, S, c, r, Dh, bf16, dev, seed=10 + i)
            for i in range(n_sets)]
    kw = dict(block_size=c, block_slots=r, scale=Dh ** -0.5)
    ms = time_ms(lambda i: bca.blockwise_causal_attn(*sets[i], **kw), n_sets)
    plain_ms = time_ms(
        lambda i: bca.blockwise_causal_attn_plain(*sets[i], **kw), n_sets)
    nb, M = S // c, (S // c) * r
    rows = torch.arange(S)
    visible = ((rows % c) + 1 + (rows // c) * r).sum().item()   # per (b, h)
    mask = torch.zeros(S, S + M, dtype=torch.bool, device=dev)
    mask[:, :S] = ((rows[:, None] // c == rows[None, :] // c)
                   & (rows[None, :] <= rows[:, None])).to(dev)
    mask[:, S:] = (torch.arange(M)[None, :] // r
                   < (rows // c)[:, None]).to(dev)
    G = H // Hkv
    lib_sets = [(q, torch.cat([k, kb], 2).repeat_interleave(G, 1),
                 torch.cat([v, vb], 2).repeat_interleave(G, 1))
                for q, k, v, kb, vb in sets]
    lib_ms = time_ms(lambda i: Fn.scaled_dot_product_attention(
        *lib_sets[i], attn_mask=mask, scale=Dh ** -0.5), n_sets)
    lib_err = (Fn.scaled_dot_product_attention(
        *lib_sets[0], attn_mask=mask, scale=Dh ** -0.5).float()
        - bca.blockwise_causal_attn(*sets[0], **kw).float()).abs().max()
    nbytes = 2 * (2 * B * H * S * Dh + 2 * B * Hkv * S * Dh
                  + 2 * B * Hkv * M * Dh)
    flops = 4 * Dh * visible * B * H
    records.append(dict(
        name="blockwise_causal_attn", route="cuda",
        source="src/repro_torch/csrc/blockwise_causal_attn.cu",
        replaces="src/repro/kernels/blockwise_causal_attn.py:301",
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bytes=nbytes, flops=flops,
        max_abs_err=errs["bca", "full", bf16]))
    log(f"  blockwise_causal_attn B={B} H={H} Hkv={Hkv} S={S} c={c} r={r} "
        f"Dh={Dh}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {lib_ms:.4f} ms (sdpa vs kernel {lib_err.item():.2e})")
    del sets, lib_sets

    (B, Hkv, G, c, M, r, Dh), _ = dec_shapes["full"]
    t_rows = [300, 1000, 2300, 4000]                # mixed pos and blk
    n_sets = 16                                     # 16 x 4 MB > 50 MB L2
    sets = [decode_inputs(B, Hkv, G, c, M, r, Dh, bf16, dev, 20 + i, t_rows)
            for i in range(n_sets)]
    ms = time_ms(lambda i: la.decode_attn(*sets[i], scale=Dh ** -0.5),
                 n_sets, iters=100)
    plain_ms = time_ms(
        lambda i: la.decode_attn_plain(*sets[i], scale=Dh ** -0.5), n_sets,
        iters=100)
    lib_sets = []
    for q, rk, rv, ck, cv, bl, bg in sets:
        keys = torch.cat([rk, ck], 2).repeat_interleave(G, 1)
        vals = torch.cat([rv, cv], 2).repeat_interleave(G, 1)
        ok = (torch.cat([bl, bg], 1) == 0)[:, None, None, :]
        lib_sets.append((q.reshape(B, Hkv * G, 1, Dh), keys, vals, ok))
    lib_ms = time_ms(lambda i: Fn.scaled_dot_product_attention(
        *lib_sets[i][:3], attn_mask=lib_sets[i][3], scale=Dh ** -0.5),
        n_sets, iters=100)
    vis = sum(t % c + 1 + (t // c) * r for t in t_rows)
    nbytes = 2 * (2 * B * Hkv * G * Dh + 2 * vis * Hkv * Dh) \
        + 4 * B * (c + M)
    flops = 4 * Dh * G * Hkv * vis
    records.append(dict(
        name="decode_attn", route="cuda",
        source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/linformer_attn.py:143",
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes,
        flops=flops, max_abs_err=errs["dec", "full", bf16]))
    log(f"  decode_attn B={B} Hkv={Hkv} G={G} c={c} M={M} Dh={Dh} "
        f"t={t_rows}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {lib_ms:.4f} ms")
    del sets, lib_sets
    for rec in records:
        t_bytes = rec.pop("bytes") / H100_BYTES_PER_S
        t_flops = rec.pop("flops") / H100_FLOPS[str(bf16)]
        rec["bound_ms"] = 1e3 * max(t_bytes, t_flops)
        rec["bound_by"] = "bytes" if t_bytes >= t_flops else "operations"
        log(f"  {rec['name']}: bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), kernel at "
            f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of it")

    # -- 5. serve at full width, 36 layers, bf16 --------------------------
    cfg = get_config("qwen3-8b")
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"H={cfg.attention.num_heads}/{cfg.attention.num_kv_heads}, "
        f"vocab {cfg.padded_vocab_size}, {cfg.dtype}")
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  params: {param_bytes(params) / 1e9:.2f} GB in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = ServingEngine(params, cfg, max_seq=4096, device=dev,
                        cache_dtype=bf16, decode_chunk=16)
    c = cfg.attention.linformer.block_size
    # k·c + j tokens; 486 + 40 crosses the block boundary at 512 while
    # decoding, so the decode-time fold runs
    lens = [c + 3, 2 * c + 17, c + 230, 3 * c + 5, 4 * c + 30, c + 1,
            2 * c + 9, 3 * c + 32]
    budgets = [32, 40, 40, 36, 48, 44, 32, 48]
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(4, cfg.vocab_size, n)))
               for n in lens]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    bca.blockwise_causal_attn.launches = 0
    la.decode_attn.launches = 0
    t0 = time.perf_counter()
    outs, sched = eng.serve(prompts, budgets, max_batch=4,
                            return_scheduler=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"blockwise_causal_attn": bca.blockwise_causal_attn.launches,
                "decode_attn": la.decode_attn.launches}
    n_tok = sum(len(o) for o in outs)
    peak = torch.cuda.max_memory_allocated()
    log(f"  {len(prompts)} requests (prompts {lens}), {n_tok} tokens in "
        f"{wall:.2f} s: {n_tok / wall:.1f} tok/s; peak memory "
        f"{peak / 1e9:.2f} GB; {sched.stats.chunks} decode chunks, mean "
        f"occupancy {sched.stats.mean_occupancy:.2f}; launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    if sched.stats.bad_rows:
        raise AssertionError(f"{sched.stats.bad_rows} rows flagged with "
                             f"non-finite logits: {sched.bad}")
    for o, b in zip(outs, budgets):
        if not (0 < len(o) <= b) or EOS in o:
            raise AssertionError(f"output of {len(o)} tokens for budget {b}")
        if len(o) < b:
            log(f"  a request ended at EOS after {len(o)} of {b} tokens")
    for rec in records:
        rec["launches"] = launches[rec["name"]]

    # where the time goes: one admission prefill and one 16-step decode
    # chunk of a full 4-row pool, each timed alone, then again under
    # torch.profiler for the device time by kernel
    pool = eng.init_pool_cache(4)
    firsts = []
    for row, p in enumerate(prompts[:4]):
        slot_cache, first = eng.prefill_request(p)
        eng.write_pool_slot(pool, slot_cache, row)
        firsts.append(first)
    cur = torch.tensor(firsts, device=dev)
    fin = torch.zeros(4, dtype=torch.bool, device=dev)
    work = {"prefill": lambda: eng.prefill_request(prompts[4]),
            "decode_chunk": lambda: eng.decode_chunk_fn(cur, fin, pool, 16)}
    for name, fn in work.items():
        fn()                                          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernels = profile_kernels(fn)
        busy = sum(t for _, _, t in kernels)
        log(f"[profile] {name}: wall {1e3 * wall:.2f} ms, device busy "
            f"{1e3 * busy:.2f} ms ({100 * busy / wall:.1f}%), "
            f"{sum(n for _, n, _ in kernels)} kernel launches")
        for kname, n, t in kernels[:8]:
            log(f"    {1e3 * t:9.3f} ms {n:6d}x  {kname[:90]}")
    del eng, params, pool
    torch.cuda.empty_cache()

    # -- 6. 2 layers, fp32: kernels vs plain reference ----------------------
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    params2 = tmodel.init_params(cfg2, seed=1, device=dev)
    prompts2 = [list(map(int, rng.integers(4, cfg.vocab_size, n)))
                for n in (c + 5, 2 * c + 9)]
    res = {}
    for backend in ("auto", "reference"):
        eng = ServingEngine(params2, cfg2, max_seq=4096, device=dev,
                            cache_dtype=torch.float32, decode_chunk=16,
                            attention_backend=backend)
        _, logits = eng.prefill(np.asarray([prompts2[1]]))
        res[backend] = (logits.float(), eng.serve(prompts2, 16, max_batch=2))
    dl = (res["auto"][0] - res["reference"][0]).abs().max().item()
    same = res["auto"][1] == res["reference"][1]
    log(f"[parity] 2-layer fp32: prefill logits max |auto - reference| = "
        f"{dl:.3e} (tol {LOGITS_TOL:g}); first 16 greedy tokens identical: "
        f"{same}")
    if not dl <= LOGITS_TOL:
        raise AssertionError(f"prefill logits differ by {dl}")
    if not same:
        raise AssertionError(f"greedy tokens differ: {res['auto'][1]} vs "
                             f"{res['reference'][1]}")
    if not all(torch.isfinite(v[0]).all() for v in res.values()):
        raise AssertionError("non-finite prefill logits")

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The bytes one train step moves on data2 × tp2, by collective op, in the
two layouts the port has: every rank holding the whole parameters and the
whole batch (the plan's regions split the batch over data inside
themselves), and the training layout (each rank its rows of the batch and
its shard of every parameter, gathered over its FSDP dims a layer at a
time and kept on its model shard: tensor parallelism with the
vocabulary-parallel head; the embedding looked up from the shards).

    python3 scripts/mesh_layout_bytes.py [--smoke] [--layers 2]

Needs a CUDA card and nvcc (`--smoke`: the SMOKE config on CPU ranks). 4
gloo ranks share the card, as in chip_smoke's `[mesh]`: qwen3-8b at full
width, fp32, B=2, S=1024, fsdp "data"; one loss and its gradients a
layout. Prints rank 0's `comm.BYTES` by op (what one rank receives,
forward and backward) and each rank's peak GB. The collectives run
through the host (gloo), so no time here is a scaling number.
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def rank_main(rank, world, tmp, smoke, layers):
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import init_ranks, make_local_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import flatten
    from repro_torch.parallel import comm, plan as plan_lib
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.sharding import ParallelCtx
    import chip_smoke as cs
    dev = torch.device("cpu" if smoke else "cuda")
    torch.set_num_threads(1 if smoke else 2)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    init_ranks("gloo", "file://" + os.path.join(tmp, "rendezvous"), rank,
               world)
    try:
        base = (get_smoke_config if smoke else get_config)("qwen3-8b")
        cfg = dataclasses.replace(base, num_layers=layers, dtype="float32")
        S = 64 if smoke else 1024
        batch = {k: v.to(dev) for k, v in cs.mesh_batch(cfg, 2, S, 0).items()}
        mesh = make_local_mesh(2, device_type=dev.type)
        out = {}
        for name, sharded in (("whole", False), ("training layout", True)):
            ctx = ParallelCtx(mesh=mesh, fsdp="data", sharded=sharded)
            params = tmodel.init_params(cfg, seed=1, device=dev)
            b = batch
            if sharded:
                params = shd.shard_tree(params, ctx)
                b = plan_lib.local_batch(batch, ctx)
            cs.free(dev)
            leaves = flatten(params)
            for p in leaves.values():
                p.requires_grad_(True)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            comm.reset_counters()
            loss, _ = tmodel.loss_fn(params, cfg, b, ctx=ctx)
            torch.autograd.grad(loss, list(leaves.values()))
            peak = (torch.cuda.max_memory_allocated() / 1e9
                    if dev.type == "cuda" else 0.0)
            out[name] = {"loss": loss.item(), "bytes": dict(comm.BYTES),
                         "peak_gb": peak,
                         "params_gb": cs.tree_bytes(params) / 1e9}
            del params, leaves, loss
            cs.free(dev)
        every = [None] * world
        dist.all_gather_object(every, out)
        if rank == 0:
            with open(os.path.join(tmp, "result.json"), "w") as fh:
                json.dump(every, fh)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    import torch.multiprocessing as mp
    import chip_smoke as cs
    if not args.smoke:
        if not torch.cuda.is_available():
            print("mesh_layout_bytes: needs a CUDA card", file=sys.stderr)
            return 1
        cs.log(cs.card_line())
        cs.build_phase()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(4, tmp, args.smoke, args.layers),
                 nprocs=4, join=True)
        with open(os.path.join(tmp, "result.json")) as fh:
            ranks = json.load(fh)
    for name, r0 in ranks[0].items():
        mb = {k: round(v / 1e6, 1) for k, v in r0["bytes"].items()}
        cs.log(f"[mesh-layout-bytes] {name}: loss {r0['loss']:.6f}; rank 0 "
               f"MB by op {mb} "
               f"(total {sum(r0['bytes'].values()) / 1e6:.1f}); parameters "
               f"a rank {r0['params_gb']:.3f} GB; peak GB "
               f"{[round(r[name]['peak_gb'], 2) for r in ranks]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

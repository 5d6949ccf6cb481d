"""Training launcher of the PyTorch port: random weights from the run's
seed, the synthetic corpus, the Trainer. Reports through `logging`. The
config's objective picks the batches: causal LM for the decoders
(qwen3-8b, qwen3-14b, nemotron-4-15b, qwen1.5-110b and the MoE decoders
qwen3-moe-30b-a3b and kimi-k2-1t-a32b, whose loss adds the weighted
load-balance loss and whose step logs it), masked LM for the paper's
encoder (linformer-paper); causal LM too for the attention-free RWKV6
(rwkv6-1.6b) and the Mamba2 hybrid (zamba2-1.2b). The frontend configs (internvl2-2b,
musicgen-large) train through make_train_step with embedding batches: the
Trainer's corpus yields tokens only and refuses them.

    python -m repro_torch.launch.train --arch qwen3-8b --smoke --device cpu
    python -m repro_torch.launch.train --arch qwen3-14b --layers 8 --steps 4 \
        --ckpt-every 0
    python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b --smoke \
        --device cpu
    python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b --layers 4 \
        --steps 2 --batch 1 --ckpt-every 0
    python -m repro_torch.launch.train --arch qwen3-8b --layers 8 --steps 4 \
        --ckpt-every 0 [--backend reference]
    python -m repro_torch.launch.train --arch linformer-paper --smoke \
        --device cpu
    python -m repro_torch.launch.train --arch linformer-paper --seq 512 \
        --batch 32 --steps 8 --ckpt-every 0
    python -m repro_torch.launch.train --arch linformer-paper --smoke \
        --device cpu --attention standard
    python -m repro_torch.launch.train --arch rwkv6-1.6b --smoke --device cpu
    python -m repro_torch.launch.train --arch zamba2-1.2b --steps 4 \
        --ckpt-every 0

On a mesh, under torchrun (the ranks come from its environment):

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch qwen3-8b \
        --smoke --mesh local --dist-backend gloo [--model-shards 2]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch qwen3-8b \
        --layers 2 --steps 4 --mesh local --dist-backend nccl

--mesh local puts every rank of the group on one mesh: --model-shards of
tensor parallelism, the rest data parallelism, with the arch's FSDP policy
(launch/mesh.fsdp_for), the Trainer's training layout. --dist-backend is
required with a mesh and has no fallback: nccl for one card a rank, gloo
for ranks that share a card (NCCL refuses two ranks on one device). A
group that fails to form raises. Rank 0 logs and writes the checkpoints.
The production meshes of the JAX launcher (TPU pod shapes) are not
ported.

--attention overrides the config's attention kind (standard | linformer |
linformer_causal), as the JAX launcher's flag does: "standard" trains the
paper's softmax baseline. The attention-free rwkv6-1.6b ignores it, as in
JAX.
Without --device the run needs a CUDA card (it raises otherwise).
--backend picks the attention route for the run: "auto" (the config's
default: the kernels), "reference" (the plain reference forms, the parity
oracle) or "fused" (the kernels, CUDA only). The
default --seq of a full config is 4096, above linformer-paper's
max_seq_len of 512: pass --seq 512 or less (a longer sequence raises a
ValueError).
Checkpoints go to --ckpt-dir/<arch> (under the temp directory by default)
every --ckpt-every steps (a quarter of the run by default, 0 for none); a
rerun with the same directory resumes from the latest one. A checkpoint
holds the parameters and both AdamW moments in fp32, 12 bytes a parameter:
about 33 GB for qwen3-8b cut to 8 layers.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile

log = logging.getLogger("repro_torch.train")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--attention", default=None,
                    choices=["standard", "linformer", "linformer_causal"],
                    help="override the config's attention kind")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config, in float32")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the "
                         "config's)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--backend", default=None,
                    choices=["auto", "reference", "fused"],
                    help="attention route (default: the config's 'auto', "
                         "the kernels)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="steps between checkpoints (default a quarter of "
                         "--steps; 0 = none)")
    ap.add_argument("--mesh", default="none", choices=["none", "local"],
                    help="local: every torchrun rank on one mesh")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="tensor-parallel width of --mesh local")
    ap.add_argument("--dist-backend", default=None,
                    choices=["nccl", "gloo"],
                    help="process-group backend of --mesh local")
    args = ap.parse_args(argv)
    if args.mesh != "none" and args.dist_backend is None:
        ap.error("--mesh local needs --dist-backend nccl or gloo")
    ctx = _mesh_ctx(args) if args.mesh != "none" else None
    logging.basicConfig(
        level=logging.INFO if ctx is None or _rank() == 0
        else logging.WARNING, format="%(message)s")

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.train import Trainer

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg, dtype="float32")
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.attention and cfg.family != "ssm":
        cfg = cfg.with_attention_kind(args.attention)
    seq = args.seq or (64 if args.smoke else 4096)
    batch = args.batch or (8 if args.smoke else 2)
    tcfg = TrainConfig(
        seq_len=seq, global_batch=batch, microbatch=args.microbatch,
        steps=args.steps, log_every=max(args.steps // 20, 1),
        checkpoint_every=(max(args.steps // 4, 1) if args.ckpt_every is None
                          else args.ckpt_every),
        checkpoint_dir=os.path.join(args.ckpt_dir, args.arch),
        optimizer=OptimizerConfig(lr=args.lr,
                                  warmup_steps=max(args.steps // 10, 1),
                                  total_steps=args.steps))
    trainer = Trainer(cfg, tcfg, device=args.device,
                      attention_backend=args.backend, ctx=ctx)
    try:
        metrics = trainer.run()
        log.info("[train] final: %s", metrics)
    finally:
        if ctx is not None:
            import torch.distributed as dist
            dist.destroy_process_group()
    return metrics


def _rank() -> int:
    return int(os.environ.get("RANK", "0"))


def _mesh_ctx(args):
    """The ParallelCtx of --mesh local: the default group from torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), then one
    mesh over all its ranks."""
    import torch
    from repro_torch.launch.mesh import fsdp_for, init_ranks, make_local_mesh
    from repro_torch.parallel.sharding import ParallelCtx
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        if var not in os.environ:
            raise RuntimeError(f"--mesh local runs under torchrun: {var} is "
                               "not set")
    if args.device.startswith("cuda"):
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              if args.dist_backend == "nccl" else 0)
    init_ranks(args.dist_backend, "env://", _rank(),
               int(os.environ["WORLD_SIZE"]))
    mesh = make_local_mesh(args.model_shards,
                           device_type="cuda" if args.device.startswith(
                               "cuda") else "cpu")
    return ParallelCtx(mesh=mesh, fsdp=fsdp_for(args.arch, False))


if __name__ == "__main__":
    main()

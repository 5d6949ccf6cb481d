"""Paper-faithful end-to-end example: MLM-pretrain a Linformer encoder
(the paper's RoBERTa-style setup, Figure 3) with checkpointing/auto-resume.

Defaults train a ~10M-param model for a few hundred steps; pass
--layers/--d-model/--steps to scale up (e.g. ~100M: --layers 12 --d-model 768
--seq 512).

    PYTHONPATH=src python examples_torch/train_mlm.py --steps 200 --k 16 \\
        [--device cpu]

Runs on the CUDA card by default (kernel 6 projects k and v, kernel 5 is
the exact Linformer attention); `--device cpu` runs their plain PyTorch
versions. A rerun with the same --ckpt-dir resumes from its last
checkpoint.
"""
import argparse
import dataclasses

from repro_torch.configs.base import (AttentionConfig, LinformerConfig,
                                      MLPConfig, OptimizerConfig, TrainConfig)
from repro_torch.configs.linformer_paper import CONFIG as PAPER_CONFIG
from repro_torch.train import Trainer


def config(args):
    """The encoder of the flags: the paper's config at their sizes, fp32,
    no remat."""
    return dataclasses.replace(
        PAPER_CONFIG,
        num_layers=args.layers,
        d_model=args.d_model,
        vocab_size=args.vocab,
        max_seq_len=args.seq,
        dtype="float32",
        remat="none",
        attention=AttentionConfig(
            kind=args.attention,
            num_heads=args.heads,
            num_kv_heads=args.heads,
            head_dim=args.d_model // args.heads,
            causal=False,
            use_rope=False,
            linformer=LinformerConfig(k=args.k, sharing=args.sharing),
        ),
        mlp=MLPConfig(d_ff=4 * args.d_model, activation="gelu"),
    )


def main(argv=None, params=None):
    """Train (or resume) the encoder; returns what it printed and the
    steps it ran. `params` is unused: the Trainer draws the weights from
    its seed, or restores them from --ckpt-dir."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--k", type=int, default=32,
                    help="Linformer projected dimension")
    ap.add_argument("--sharing", default="layerwise",
                    choices=["none", "headwise", "kv", "layerwise"])
    ap.add_argument("--attention", default="linformer",
                    choices=["linformer", "standard"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_mlm_ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = config(args)
    n_params = cfg.param_count_estimate
    print(f"MLM pretraining: {args.attention} k={args.k} "
          f"sharing={args.sharing} ~{n_params/1e6:.1f}M params")

    tcfg = TrainConfig(
        seq_len=args.seq, global_batch=args.batch, steps=args.steps,
        log_every=max(args.steps // 10, 1), checkpoint_every=args.steps // 2,
        checkpoint_dir=args.ckpt_dir,
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps=args.steps // 10,
                                  total_steps=args.steps))
    trainer = Trainer(cfg, tcfg, device=args.device)  # auto-resumes
    metrics = trainer.run()
    print(f"done: loss={metrics['loss']:.4f} ppl={metrics['perplexity']:.2f}")
    return {"n_params": n_params, "loss": metrics["loss"],
            "perplexity": metrics["perplexity"],
            "steps": [h["step"] for h in trainer.history],
            "losses": [h["loss"] for h in trainer.history]}


if __name__ == "__main__":
    main()

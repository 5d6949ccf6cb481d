"""Quickstart: build a small Linformer causal LM, train it briefly on the
synthetic corpus, checkpoint, and generate text — the whole public API of
the PyTorch port in ~50 lines.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

Runs on the CUDA card by default (the port's kernels: 1r and 2 in the
training steps, 1 and 3 in serving); `--device cpu` runs their plain
PyTorch versions.
"""
import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.serving import ServingEngine
from repro_torch.train import Trainer


def main(argv=None, params=None):
    """Train, checkpoint and serve; returns what it printed. `params` is
    unused: the weights are the ones the Trainer trains from its seed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. a reduced qwen3-style decoder with blockwise-causal Linformer attention
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype="float32")
    lin = cfg.attention.linformer
    print(f"model: {cfg.name} | attention: {cfg.attention.kind} "
          f"(block={lin.block_size}, r={lin.block_slots})")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        tcfg = TrainConfig(
            seq_len=64, global_batch=8, steps=60, log_every=20,
            checkpoint_every=30, checkpoint_dir=ckpt_dir,
            optimizer=OptimizerConfig(lr=2e-3, warmup_steps=10,
                                      total_steps=60))
        trainer = Trainer(cfg, tcfg, device=args.device)
        metrics = trainer.run()
        print(f"final loss: {metrics['loss']:.3f} "
              f"(ppl {metrics['perplexity']:.1f})")
        checkpoints = sorted(trainer.ckpt.all_steps())

        # 2. serve the trained model with the compressed Linformer cache
        engine = ServingEngine(trainer._params, cfg, max_seq=128,
                               device=args.device, cache_dtype=torch.float32)
        prompts = [[1, 10, 20, 30], [1, 42, 42, 42]]
        outs = engine.serve(prompts, max_new_tokens=12)
        for p, o in zip(prompts, outs):
            print(f"prompt {p} -> generated {o}")
        cache_bytes = engine.cache_bytes(2)
        print(f"decode cache: {cache_bytes} bytes "
              f"(compressed; standard cache would be larger)")
    return {"losses": [h["loss"] for h in trainer.history],
            "loss": metrics["loss"], "perplexity": metrics["perplexity"],
            "checkpoints": checkpoints, "prompts": prompts, "outputs": outs,
            "cache_bytes": cache_bytes}


if __name__ == "__main__":
    main()

"""nemotron-4-15b — [dense] 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — GQA, squared-ReLU. [arXiv:2402.16819; unverified]
"""
from repro_torch.configs.base import (
    AttentionConfig,
    LinformerConfig,
    MLPConfig,
    ModelConfig,
)

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    vocab_size=256000,
    max_seq_len=524288,
    attention=AttentionConfig(
        kind="linformer_causal",
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        qk_norm=False,
        linformer=LinformerConfig(k=256, sharing="layerwise",
                                  block_size=256, block_slots=16),
    ),
    mlp=MLPConfig(d_ff=24576, activation="squared_relu"),
)

SMOKE = ModelConfig(
    name="nemotron-4-15b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    vocab_size=512,
    max_seq_len=256,
    attention=AttentionConfig(
        kind="linformer_causal",
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        linformer=LinformerConfig(k=16, block_size=16, block_slots=4),
    ),
    mlp=MLPConfig(d_ff=128, activation="squared_relu"),
    remat="none",
)

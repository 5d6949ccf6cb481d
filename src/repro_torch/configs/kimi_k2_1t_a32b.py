"""kimi-k2-1t-a32b — [moe] 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384e top-8 — trillion-param MoE. [arXiv:2501.kimi2; unverified]
"""
from repro_torch.configs.base import (
    AttentionConfig,
    LinformerConfig,
    MLPConfig,
    MoEConfig,
    ModelConfig,
)

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    vocab_size=163840,
    max_seq_len=524288,
    attention=AttentionConfig(
        kind="linformer_causal",
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        linformer=LinformerConfig(k=256, sharing="layerwise",
                                  block_size=256, block_slots=16),
    ),
    mlp=MLPConfig(d_ff=2048, activation="swiglu"),
    moe=MoEConfig(num_experts=384, top_k=8, expert_d_ff=2048,
                  capacity_factor=1.25),
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke",
    family="moe",
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
    mlp=MLPConfig(d_ff=64, activation="swiglu"),
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=64,
                  capacity_factor=8.0),
    remat="none",
)

"""qwen3-moe-30b-a3b — [moe] 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128e top-8. [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs.base import (
    AttentionConfig,
    LinformerConfig,
    MLPConfig,
    MoEConfig,
    ModelConfig,
)

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    vocab_size=151936,
    max_seq_len=524288,
    attention=AttentionConfig(
        kind="linformer_causal",
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        qk_norm=True,
        rope_theta=1_000_000.0,
        linformer=LinformerConfig(k=256, sharing="layerwise",
                                  block_size=256, block_slots=16),
    ),
    mlp=MLPConfig(d_ff=768, activation="swiglu"),
    moe=MoEConfig(num_experts=128, top_k=8, expert_d_ff=768,
                  capacity_factor=1.25),
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
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
        qk_norm=True,
        linformer=LinformerConfig(k=16, block_size=16, block_slots=4),
    ),
    mlp=MLPConfig(d_ff=64, activation="swiglu"),
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=64,
                  capacity_factor=8.0),
    remat="none",
)

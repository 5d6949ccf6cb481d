"""qwen3-14b — [dense] 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936
qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import (
    AttentionConfig,
    LinformerConfig,
    MLPConfig,
    ModelConfig,
)

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    vocab_size=151936,
    max_seq_len=524288,
    attention=AttentionConfig(
        kind="linformer_causal",
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        qk_norm=True,
        rope_theta=1_000_000.0,
        linformer=LinformerConfig(k=256, sharing="layerwise",
                                  block_size=256, block_slots=16),
    ),
    mlp=MLPConfig(d_ff=17408, activation="swiglu"),
)

SMOKE = ModelConfig(
    name="qwen3-14b-smoke",
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
        qk_norm=True,
        linformer=LinformerConfig(k=16, block_size=16, block_slots=4),
    ),
    mlp=MLPConfig(d_ff=128, activation="swiglu"),
    remat="none",
)

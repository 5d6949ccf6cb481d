"""qwen1.5-110b — [dense] 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064 — QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.configs.base import (
    AttentionConfig,
    LinformerConfig,
    MLPConfig,
    ModelConfig,
)

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    vocab_size=152064,
    max_seq_len=524288,
    attention=AttentionConfig(
        kind="linformer_causal",
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        qkv_bias=True,
        linformer=LinformerConfig(k=256, sharing="layerwise",
                                  block_size=256, block_slots=16),
    ),
    mlp=MLPConfig(d_ff=49152, activation="swiglu"),
)

SMOKE = ModelConfig(
    name="qwen1.5-110b-smoke",
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
        qkv_bias=True,
        linformer=LinformerConfig(k=16, block_size=16, block_slots=4),
    ),
    mlp=MLPConfig(d_ff=128, activation="swiglu"),
    remat="none",
)

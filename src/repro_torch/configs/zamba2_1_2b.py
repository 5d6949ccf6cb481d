"""zamba2-1.2b — [hybrid] 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks. [arXiv:2411.15242; hf]

Trunk of Mamba2 (SSD) blocks; a single attention+MLP block with SHARED weights
is invoked every `hybrid_attn_every` trunk layers (Zamba2's weight-tied global
block). The shared attention block is where Linformer applies.
"""
from repro_torch.configs.base import (
    AttentionConfig,
    LinformerConfig,
    MLPConfig,
    ModelConfig,
    SSMConfig,
)

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    vocab_size=32000,
    max_seq_len=524288,
    hybrid_attn_every=6,
    attention=AttentionConfig(
        kind="linformer_causal",
        num_heads=32,
        num_kv_heads=32,     # MHA in the shared block
        head_dim=64,
        linformer=LinformerConfig(k=256, sharing="layerwise",
                                  block_size=256, block_slots=16),
    ),
    mlp=MLPConfig(d_ff=8192, activation="swiglu"),
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  chunk_size=128),
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    num_layers=4,
    d_model=64,
    vocab_size=512,
    max_seq_len=256,
    hybrid_attn_every=2,
    attention=AttentionConfig(
        kind="linformer_causal",
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        linformer=LinformerConfig(k=16, block_size=16, block_slots=4),
    ),
    mlp=MLPConfig(d_ff=128, activation="swiglu"),
    ssm=SSMConfig(state_dim=8, head_dim=16, expand=2, conv_width=4,
                  chunk_size=16),
    remat="none",
)

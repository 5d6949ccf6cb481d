"""The paper's own model: RoBERTa-base-like 12L encoder with exact Linformer
attention (Eq. 7), n=512, k=128, layerwise-shared E, learned positions,
GELU MLP, MLM objective. Copy of ``repro/configs/linformer_paper.py``.
"""
from repro_torch.configs.base import (
    AttentionConfig,
    LinformerConfig,
    MLPConfig,
    ModelConfig,
)

CONFIG = ModelConfig(
    name="linformer-paper-base",
    family="dense",
    num_layers=12,
    d_model=768,
    vocab_size=50265,
    max_seq_len=512,
    objective="mlm",
    attention=AttentionConfig(
        kind="linformer",       # exact bidirectional form, Eq. 7
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        causal=False,
        use_rope=False,         # learned positions, RoBERTa-style
        linformer=LinformerConfig(k=128, sharing="layerwise",
                                  projection="linear"),
    ),
    mlp=MLPConfig(d_ff=3072, activation="gelu"),
)

SMOKE = ModelConfig(
    name="linformer-paper-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    vocab_size=512,
    max_seq_len=128,
    objective="mlm",
    attention=AttentionConfig(
        kind="linformer",
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        causal=False,
        use_rope=False,
        linformer=LinformerConfig(k=16, sharing="layerwise"),
    ),
    mlp=MLPConfig(d_ff=128, activation="gelu"),
    remat="none",
)

"""internvl2-2b — [vlm] 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553
InternViT + InternLM2. [arXiv:2404.16821; hf]

The InternViT vision frontend is a stub: the batch supplies precomputed patch
embeddings (B, n_patches, d_model) prepended to the token stream. The
InternLM2 language backbone is fully implemented.
"""
from repro_torch.configs.base import (
    AttentionConfig,
    LinformerConfig,
    MLPConfig,
    ModelConfig,
)

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    vocab_size=92553,
    max_seq_len=524288,
    frontend_embed_len=256,   # ViT patch embeddings prepended (448px/14 -> 1024 -> pixel-shuffle 256)
    attention=AttentionConfig(
        kind="linformer_causal",
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        linformer=LinformerConfig(k=256, sharing="layerwise",
                                  block_size=256, block_slots=16),
    ),
    mlp=MLPConfig(d_ff=8192, activation="swiglu"),
)

SMOKE = ModelConfig(
    name="internvl2-2b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    vocab_size=512,
    max_seq_len=256,
    frontend_embed_len=8,
    attention=AttentionConfig(
        kind="linformer_causal",
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        linformer=LinformerConfig(k=16, block_size=16, block_slots=4),
    ),
    mlp=MLPConfig(d_ff=128, activation="swiglu"),
    remat="none",
)

"""musicgen-large — [audio] 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

The EnCodec audio frontend is a stub: the batch supplies precomputed frame
embeddings (B, S, d_model); ``embedding_inputs`` skips the token-embedding
lookup. The LM head projects to the 2048-entry EnCodec codebook. MusicGen's
4-codebook delay pattern is collapsed to a single interleaved stream
(backbone compute is equivalent).
"""
from repro_torch.configs.base import (
    AttentionConfig,
    LinformerConfig,
    MLPConfig,
    ModelConfig,
)

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    vocab_size=2048,
    max_seq_len=524288,
    embedding_inputs=True,
    attention=AttentionConfig(
        kind="linformer_causal",
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        linformer=LinformerConfig(k=256, sharing="layerwise",
                                  block_size=256, block_slots=16),
    ),
    mlp=MLPConfig(d_ff=8192, activation="gelu"),
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    vocab_size=128,
    max_seq_len=256,
    embedding_inputs=True,
    attention=AttentionConfig(
        kind="linformer_causal",
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        linformer=LinformerConfig(k=16, block_size=16, block_slots=4),
    ),
    mlp=MLPConfig(d_ff=128, activation="gelu"),
    remat="none",
)

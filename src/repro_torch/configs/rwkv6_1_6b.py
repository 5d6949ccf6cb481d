"""rwkv6-1.6b — [ssm] 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536
Finch — data-dependent decay. [arXiv:2404.05892; unverified]

Linformer is INAPPLICABLE here (no attention matrix to approximate — the model
is already O(n) time / O(1) state); implemented without the technique. See
DESIGN.md §5.1 Arch-applicability.
"""
from repro_torch.configs.base import (
    AttentionConfig,
    MLPConfig,
    ModelConfig,
    RWKVConfig,
)

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    vocab_size=65536,
    max_seq_len=524288,
    attention=AttentionConfig(kind="standard", num_heads=32, num_kv_heads=32,
                              head_dim=64),  # unused; kept for uniform API
    mlp=MLPConfig(d_ff=7168, activation="squared_relu"),  # rwkv channel-mix uses relu^2
    rwkv=RWKVConfig(head_dim=64, chunk_size=128),
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    vocab_size=512,
    max_seq_len=256,
    attention=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=16),
    mlp=MLPConfig(d_ff=128, activation="squared_relu"),
    rwkv=RWKVConfig(head_dim=16, chunk_size=16),
    remat="none",
)

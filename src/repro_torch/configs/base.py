"""Configuration dataclasses for the repro framework.

Everything in the framework is driven by a single `ModelConfig` plus the
run-level `TrainConfig` / `ServeConfig` / `MeshConfig`. Configs are plain
frozen dataclasses so they are hashable (usable as jit static args) and
trivially serializable.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Attention / Linformer
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LinformerConfig:
    """Configuration of the paper's technique.

    The exact (bidirectional) form follows Eq. 7 of the paper: learned
    E,F in R^{n x k} compress the sequence axis of K and V.

    The causal form ("linformer_causal") uses the paper's convolutional
    projection (kernel = stride = block_size, producing `block_slots`
    compressed slots per block) with block-granular causality; see DESIGN.md §4.
    """

    # projected dimension k (exact form). Paper sweeps 64..512; 128/256 typical.
    k: int = 128
    # E/F parameter sharing: "none" | "headwise" | "kv" | "layerwise"
    sharing: str = "layerwise"
    # projection kind for the exact form: "linear" | "conv" | "pool"
    projection: str = "linear"
    # --- causal (blockwise) form ---
    block_size: int = 256          # c: tokens per compressed block
    block_slots: int = 16          # r: compressed slots per block
    # non-uniform k: optional per-layer scaling (higher layers lower rank).
    # fraction of k kept at the last layer; 1.0 = uniform.
    k_decay: float = 1.0


@dataclass(frozen=True)
class AttentionConfig:
    kind: str = "standard"          # "standard" | "linformer" | "linformer_causal"
    # compute backend for the linformer kinds:
    #   "auto"      — resolved per platform by kernels/ops.resolve_backend
    #                 (fused Pallas kernels: Mosaic on TPU, interpret on CPU)
    #   "fused"     — force the Pallas kernel path
    #   "reference" — force the pure-jnp einsum implementations
    backend: str = "auto"
    # backward implementation of the fused blockwise-causal attention
    # (linformer_causal training through the Pallas kernels):
    #   "fused"     — Pallas backward from saved (m, denom) softmax residuals
    #   "reference" — recompute through the pure-jnp reference VJP (parity
    #                 oracle; a second unfused attention pass per step)
    backward_impl: str = "fused"
    num_heads: int = 8
    num_kv_heads: int = 8           # GQA: kv heads (== num_heads -> MHA)
    head_dim: int = 64
    qk_norm: bool = False           # Qwen3-style RMSNorm on q,k head dims
    qkv_bias: bool = False          # Qwen1.5-style bias on q,k,v projections
    rope_theta: float = 10000.0
    use_rope: bool = True
    causal: bool = True
    linformer: LinformerConfig = field(default_factory=LinformerConfig)

    @property
    def q_per_kv(self) -> int:
        assert self.num_heads % self.num_kv_heads == 0
        return self.num_heads // self.num_kv_heads


# ---------------------------------------------------------------------------
# Feed-forward / MoE / SSM
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLPConfig:
    d_ff: int = 2048
    activation: str = "swiglu"      # "swiglu" | "squared_relu" | "gelu"


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # 0 -> dense MLP
    top_k: int = 2
    expert_d_ff: int = 2048
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    # shard experts over this mesh axis
    expert_axis: str = "model"
    # --- perf knobs (EXPERIMENTS.md §Perf) ---
    # per-expert capacity floor of 1 instead of top_k: removes the 8x padded
    # expert compute at tiny decode batches (iteration kimi/decode_32k #1).
    # Tradeoff: at very small token counts, routing collisions can drop
    # tokens unless capacity_factor gives headroom (serving configs should
    # size cf so C >= expected load x skew; tests use dropless cf).
    capacity_floor_one: bool = True
    # decode-time weight-stationary EP: tokens replicate (tiny), expert
    # weights stay sharded over (model x fsdp) — no per-step weight gather
    # (iteration kimi/decode_32k #2)
    weight_stationary_decode: bool = True


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block config."""

    state_dim: int = 64             # N
    head_dim: int = 64              # P
    num_heads: int = 0              # derived from d_inner/head_dim if 0
    expand: int = 2                 # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 128           # SSD chunk for parallel training


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 (Finch) config."""

    head_dim: int = 64
    chunk_size: int = 128


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int = 12
    d_model: int = 768
    vocab_size: int = 32000
    max_seq_len: int = 4096
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    mlp: MLPConfig = field(default_factory=MLPConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    rwkv: RWKVConfig = field(default_factory=RWKVConfig)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # decoder ("causal_lm") or encoder ("mlm") objective
    objective: str = "causal_lm"
    # hybrid (zamba2): attention block shared across invocations, applied
    # every `hybrid_attn_every` mamba layers.
    hybrid_attn_every: int = 6
    # vlm/audio frontends are stubs: inputs may include precomputed embeddings
    # of this many positions (prepended to token embeddings).
    frontend_embed_len: int = 0
    # embedding-only input (musicgen: EnCodec frame embeddings, no token lookup)
    embedding_inputs: bool = False
    dtype: str = "bfloat16"         # params/activations
    remat: str = "full"             # "none" | "dots" | "full"
    # scan layers (stacked params). Always true for prod; smoke may disable.
    scan_layers: bool = True
    # embedding/lm-head vocab rows are padded up to a multiple of this so the
    # vocab axis shards evenly under tensor parallelism (standard practice;
    # padded ids are never used as labels).
    vocab_pad_multiple: int = 256
    # --- perf knobs (EXPERIMENTS.md §Perf) ---
    # build the decode cache inside the SAME forward pass at prefill instead
    # of a second full pass (iteration qwen3-8b/prefill_32k #1)
    single_pass_cache: bool = True
    # shard the residual stream's sequence axis over "model" between blocks
    # (sequence parallelism for norms/activations; Korthikanti et al.) —
    # cuts saved-carry memory by the TP width (iteration qwen1.5/train #2)
    seq_shard_activations: bool = False
    # compute the LM-head matmul + cross-entropy in sequence chunks of this
    # many tokens (0 = off): logits are never fully materialized
    # (iteration qwen1.5/train #3)
    chunked_ce: int = 0

    @property
    def padded_vocab_size(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    def with_attention_kind(self, kind: str) -> "ModelConfig":
        return dataclasses.replace(
            self, attention=dataclasses.replace(self.attention, kind=kind)
        )

    def with_attention_backend(self, backend: str) -> "ModelConfig":
        return dataclasses.replace(
            self, attention=dataclasses.replace(self.attention, backend=backend)
        )

    def with_backward_impl(self, backward_impl: str) -> "ModelConfig":
        return dataclasses.replace(
            self, attention=dataclasses.replace(self.attention,
                                                backward_impl=backward_impl)
        )

    @property
    def param_count_estimate(self) -> int:
        """Rough parameter count (embeddings + blocks), for roofline MODEL_FLOPS."""
        a, D, L = self.attention, self.d_model, self.num_layers
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # rwkv6
            d_ff = self.mlp.d_ff
            per = (
                4 * D * D            # r,k,v,g (time-mix)
                + D * D              # output
                + D * d_ff + d_ff * D  # channel mix
                + 10 * D             # mus/decay small params (approx)
            )
            return emb + L * per
        attn = D * (a.num_heads * a.head_dim) + 2 * D * (a.num_kv_heads * a.head_dim) \
            + (a.num_heads * a.head_dim) * D
        if self.moe.num_experts > 0:
            ff = self.moe.num_experts * 3 * D * self.moe.expert_d_ff \
                + D * self.moe.num_experts
        else:
            mult = 3 if self.mlp.activation == "swiglu" else 2
            ff = mult * D * self.mlp.d_ff
        if self.family == "hybrid":
            # mamba trunk + one shared attention+mlp block
            d_inner = self.ssm.expand * D
            per_mamba = D * (2 * d_inner + 2 * self.ssm.state_dim *
                             (d_inner // self.ssm.head_dim if self.ssm.head_dim else 1))
            per_mamba = 2 * D * d_inner + d_inner * D + 2 * d_inner * self.ssm.state_dim
            mult = 3 if self.mlp.activation == "swiglu" else 2
            return emb + L * per_mamba + (attn + mult * D * self.mlp.d_ff)
        return emb + L * (attn + ff)

    @property
    def active_param_count_estimate(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.moe.num_experts == 0:
            return self.param_count_estimate
        a, D, L = self.attention, self.d_model, self.num_layers
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        attn = D * (a.num_heads * a.head_dim) + 2 * D * (a.num_kv_heads * a.head_dim) \
            + (a.num_heads * a.head_dim) * D
        ff = self.moe.top_k * 3 * D * self.moe.expert_d_ff + D * self.moe.num_experts
        return emb + L * (attn + ff)


# ---------------------------------------------------------------------------
# Run-level configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the assignment."""

    name: str = "train_4k"
    seq_len: int = 4096
    global_batch: int = 256
    kind: str = "train"             # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False
    # fsdp axes that parameters are additionally sharded over ("" = none)
    fsdp: str = "none"              # "none" | "data" | "pod_data"


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"        # "cosine" | "linear" | "constant"
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # dtype of Adam moments ("float32" | "bfloat16") — bf16 halves opt memory
    moment_dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    seq_len: int = 512
    global_batch: int = 8
    microbatch: int = 0             # 0 = no accumulation
    # error-feedback int8 gradient reduction across the "pod" axis (DCN):
    # requires a multi-pod mesh; see train/compressed_dp.py
    compressed_pod_grads: bool = False
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    seed: int = 0
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    mlm_mask_prob: float = 0.15


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq_len: int = 2048
    prefill_chunk: int = 512
    temperature: float = 0.0        # 0 = greedy

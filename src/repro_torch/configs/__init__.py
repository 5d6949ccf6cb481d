"""Architecture registry of the PyTorch port: ``--arch <id>`` resolves here.

The config dataclasses in ``base.py`` are copies of the JAX package's, field
for field, so ``dataclasses.asdict`` of a JAX config rebuilds the same config
here. The port covers every dense-transformer config: the decoders
``qwen3-8b``, ``qwen3-14b``, ``nemotron-4-15b`` and ``qwen1.5-110b``, the
decoders behind stub frontends ``internvl2-2b`` (vision patches prepended)
and ``musicgen-large`` (frame embeddings in place of tokens), and the
paper's ``linformer-paper`` encoder; and the MoE decoders
``qwen3-moe-30b-a3b`` and ``kimi-k2-1t-a32b`` (models/moe.py, on one
device); the attention-free RWKV6 ``rwkv6-1.6b`` (family ssm,
models/rwkv_model.py) and the Mamba2 hybrid ``zamba2-1.2b`` (family
hybrid, models/zamba.py), whose shared attention block is blockwise-causal
Linformer.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    AttentionConfig,
    LinformerConfig,
    MLPConfig,
    MoEConfig,
    ModelConfig,
    RWKVConfig,
    SSMConfig,
)

# arch id (public, dashed) -> module name
_ARCH_MODULES: Dict[str, str] = {
    "qwen3-8b": "qwen3_8b",
    "qwen3-14b": "qwen3_14b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen1.5-110b": "qwen1_5_110b",
    "internvl2-2b": "internvl2_2b",
    "musicgen-large": "musicgen_large",
    "linformer-paper": "linformer_paper",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "zamba2-1.2b": "zamba2_1_2b",
}


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the PyTorch port "
                       f"covers {sorted(_ARCH_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    """Full published config for an architecture."""
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config for CPU tests."""
    return _module(arch_id).SMOKE


def config_from_dict(d: Dict) -> ModelConfig:
    """Rebuild a ModelConfig from ``dataclasses.asdict`` output (of this
    package's config or of the JAX package's identical dataclass)."""
    d = dict(d)
    att = dict(d.pop("attention"))
    att["linformer"] = LinformerConfig(**att["linformer"])
    return ModelConfig(
        attention=AttentionConfig(**att), mlp=MLPConfig(**d.pop("mlp")),
        moe=MoEConfig(**d.pop("moe")), ssm=SSMConfig(**d.pop("ssm")),
        rwkv=RWKVConfig(**d.pop("rwkv")), **d)

"""Weight bridge from the JAX package's checkpoints to the port.

The JAX checkpointer (``repro/checkpoint/checkpointer.py`` ``_flatten``)
stores a params pytree as ``{key: np.ndarray}`` keyed by "/"-joined pytree
paths, with layer-stacked leaves such as ``layers/attn/wq`` (L, d, H·Dh) and
bf16 widened to fp32. The port keeps the same keys, shapes and (in, out)
weight orientation, so bridging is a checked copy, never a transpose.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models.model import param_spec
from repro_torch.models.transformer import nest, torch_dtype


def params_from_flat(flat: Mapping[str, np.ndarray], cfg: ModelConfig, *,
                     device: Union[str, torch.device] = "cuda",
                     dtype: Union[str, torch.dtype, None] = None) -> Dict:
    """Port parameters from a flat ``{key: array}`` checkpoint dict.

    Every key of the model's parameter layout must be present with its
    shape; extra keys are an error too (a checkpoint of another config).
    Each leaf takes its dtype from the parameter spec: the config's, or
    `dtype` where given, for all but the leaves JAX keeps in fp32 (the MoE
    router; the SSM families' decay, skip and bonus leaves), which stay
    fp32."""
    dev = resolve_device(device)
    if dtype is not None:
        if not isinstance(dtype, str):
            dtype = {torch_dtype(n): n for n in ("float32", "bfloat16")}[dtype]
        cfg = dataclasses.replace(cfg, dtype=dtype)
    spec = param_spec(cfg)
    missing = sorted(set(spec) - set(flat))
    extra = sorted(set(flat) - set(spec))
    if missing or extra:
        raise KeyError(f"checkpoint does not match {cfg.name!r}: missing "
                       f"{missing}, unexpected {extra}")
    out = {}
    for key, (shape, _, leaf_dt) in spec.items():
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{arr.shape} vs model {shape}")
        # np.array copies: a read-only buffer would make torch warn
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        out[key] = t.to(device=dev, dtype=leaf_dt)
    return nest(out)


def read_params_npz(path: str) -> Dict[str, np.ndarray]:
    """Read a JAX checkpoint's ``params.npz`` (a file, or a step directory
    holding one) with numpy alone."""
    if os.path.isdir(path):
        path = os.path.join(path, "params.npz")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


"""PyTorch/CUDA port of the Linformer repro.

Mirrors the JAX package's module names (``repro.X.Y`` -> ``repro_torch.X.Y``)
so the counterpart of every module is easy to find. Imports neither JAX nor
any module of the JAX package. Entry points default to ``device="cuda"`` and
run on the CPU only when the caller passes ``device="cpu"``; every Pallas
kernel on the ported path has a hand-written CUDA C++ counterpart under
``csrc/``.
"""

"""Build and load the port's CUDA kernels.

Every ``src/repro_torch/csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a`` and linked into one shared library with
a plain C interface, which ``ctypes`` loads. The library lives in
``build/repro_torch/`` at the root of the checkout, keyed by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one loads
at once. PyTorch's extension builder is not used: it needs ``ninja`` and its
headers cost minutes per build. Without ``nvcc`` this raises; there is no
fallback.

The build happens on first use (the first kernel launch, or an explicit
``library()`` call), never at import.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL_PTR = ctypes.POINTER(ctypes.c_longlong)

# exported C function -> (restype, argtypes)
SIGNATURES: Dict[str, Tuple[object, List[object]]] = {
    # q, k, v, kbar, vbar, out, m, denom, start_blocks, kbar_scale,
    # vbar_scale, strides[15], B, H, Hkv, S, M, Dh, block_size, block_slots,
    # scale, dtype, slot_dtype, stream
    "bca_forward": (_I, [_P] * 11 + [_LL_PTR] + [_I] * 8
                    + [ctypes.c_float, _I, _I, _P]),
    # q, k, v, kbar, vbar, dout, m, denom, start_blocks, dq, delta, dk, dv,
    # dkbar, dvbar, part, strides[21], B, H, Hkv, S, M, Dh, block_size,
    # block_slots, scale, dtype, stream
    "bca_backward": (_I, [_P] * 16 + [_LL_PTR] + [_I] * 8
                     + [ctypes.c_float, _I, _P]),
    # the kernel(s) the last bca_forward / bca_backward launched: 0 SIMT, 1
    # tensor cores
    "bca_forward_route": (_I, []),
    "bca_backward_route": (_I, []),
    # q, raw_k, raw_v, comp_k, comp_v, raw_k_s, raw_v_s, comp_k_s, comp_v_s,
    # bias_loc, bias_glob, out, part, strides[12], B, Hkv, G, Dh, c, M,
    # nsplit, tiles_per_split, scale, dtype, cache_dtype, stream
    "decode_forward": (_I, [_P] * 13 + [_LL_PTR] + [_I] * 8
                       + [ctypes.c_float, _I, _I, _P]),
    # q, kbar, vbar, out, strides[9], B, H, Hkv, S, K, Dh, scale, dtype,
    # stream
    "linformer_attn_forward": (_I, [_P] * 4 + [_LL_PTR] + [_I] * 6
                               + [ctypes.c_float, _I, _P]),
    # x, E, out, strides[7], B, H, S, K, Dh, dtype, stream
    "seq_projection_forward": (_I, [_P] * 3 + [_LL_PTR] + [_I] * 6 + [_P]),
    "repro_torch_error_string": (ctypes.c_char_p, [_I]),
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float      # 0.0 when an existing build was loaded
    log: str                  # nvcc output, -Xptxas -v lines included

    def check(self, rc: int, what: str) -> None:
        """Raise on a non-zero cudaError_t returned by a launcher."""
        if rc != 0:
            msg = self.lib.repro_torch_error_string(rc).decode()
            raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the CUDA "
        "kernels of repro_torch cannot be built")


def _build(lib_path: Path) -> Tuple[float, str]:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="build_", dir=BUILD_DIR))
    try:
        srcs = sources()
        objs = [tmp / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "\n".join(f"== {s.name}\n{text}" for s, text in zip(srcs, logs))
        failed = [s.name for s, p in zip(srcs, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        so = tmp / lib_path.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        log += link.stdout
        (BUILD_DIR / (lib_path.stem + ".log")).write_text(log)
        os.replace(so, lib_path)      # atomic: concurrent loaders see it whole
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return time.perf_counter() - t0, log


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """The kernel library, built on first use and loaded once per process."""
    lib_path = BUILD_DIR / f"librepro_torch_{source_hash()}.so"
    seconds, log = 0.0, ""
    if not lib_path.exists():
        seconds, log = _build(lib_path)
    else:
        log_path = BUILD_DIR / (lib_path.stem + ".log")
        log = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(lib_path))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return KernelLibrary(lib=lib, path=lib_path, build_seconds=seconds,
                         log=log)


def strides_arg(*tensors_dims) -> ctypes.Array:
    """Pack (tensor, dims) strides, in elements, into a C int64 array; a
    None tensor (an absent optional operand) packs zeros."""
    vals = [0 if t is None else t.stride(d)
            for t, dims in tensors_dims for d in dims]
    return (ctypes.c_longlong * len(vals))(*vals)

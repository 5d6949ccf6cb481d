"""Fault-tolerant checkpointing, in the JAX package's on-disk format.

Counterpart of ``repro/checkpoint/checkpointer.py``:

* Atomic: written to ``step_<N>.tmp/`` then renamed, so a preempted writer
  never corrupts the latest checkpoint.
* The same files and keys: one ``<name>.npz`` per saved tree, keyed by
  "/"-joined paths (``layers/attn/wq``, ``mu/embed/tok``, ``step``), bf16
  widened to fp32 (npz has no bf16), and ``metadata.json`` with the step and
  the data-pipeline state. A checkpoint written here restores through the
  JAX ``Checkpointer`` and ``bridge.read_params_npz``, and one written by
  the JAX package restores here.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import flatten, nest


def _to_numpy(tree: Dict) -> Dict[str, np.ndarray]:
    out = {}
    for key, t in flatten(tree).items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        out[key] = t.numpy()
    return out


def _from_numpy(template: Dict, flat: Dict[str, np.ndarray]) -> Dict:
    """Tensors shaped, typed and placed like `template`'s leaves."""
    out = {}
    for key, t in flatten(template).items():
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs "
                f"{tuple(t.shape)}")
        out[key] = torch.from_numpy(np.array(arr)).to(dtype=t.dtype,
                                                      device=t.device)
    return nest(out)


# members below this many bytes are read whole; larger stored (uncompressed)
# members are memory-mapped, so a restore that keeps a shard of a leaf
# reads the shard's pages, not the leaf
_MMAP_MIN_BYTES = 1 << 20


def _npz_arrays(path: str) -> Dict[str, np.ndarray]:
    """{key: array} of an npz (np.savez's layout): a large member stored
    uncompressed as a read-only memory map of its data, the rest read."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as fh:
        for info in zf.infolist():
            key = info.filename[:-len(".npy")]
            if (info.compress_type != zipfile.ZIP_STORED
                    or info.file_size < _MMAP_MIN_BYTES):
                with zf.open(info) as f:
                    out[key] = np.lib.format.read_array(f)
                continue
            fh.seek(info.header_offset + 26)     # the local header's lengths
            name_len, extra_len = struct.unpack("<HH", fh.read(4))
            fh.seek(info.header_offset + 30 + name_len + extra_len)
            major, _ = np.lib.format.read_magic(fh)
            read = (np.lib.format.read_array_header_1_0 if major == 1
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(fh)
            out[key] = np.memmap(path, dtype=dtype, mode="r", shape=shape,
                                 offset=fh.tell(),
                                 order="F" if fortran else "C")
    return out


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int, tmp: bool = False) -> str:
        return os.path.join(self.directory,
                            f"step_{step:08d}" + (".tmp" if tmp else ""))

    def save(self, step: int, state: Dict[str, Any],
             metadata: Optional[Dict] = None) -> str:
        """Write the named trees of `state` (nested dicts of tensors)
        atomically."""
        tmp, final = self._path(step, tmp=True), self._path(step)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for name, tree in state.items():
            np.savez(os.path.join(tmp, f"{name}.npz"), **_to_numpy(tree))
        meta = dict(metadata or {})
        meta["step"] = step
        with open(os.path.join(tmp, "metadata.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    def all_steps(self):
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, templates: Dict[str, Any],
                transform=None) -> Tuple[Dict[str, Any], Dict]:
        """Restore named trees; `templates` gives structure, shape, dtype
        and device. `transform(name, key, array)`, applied to each leaf as
        it is read (one whole leaf in memory at a time), may cut it to the
        template's shape (a rank's shard of a mesh)."""
        d = self._path(step)
        out = {}
        for name, template in templates.items():
            arrays = _npz_arrays(os.path.join(d, f"{name}.npz"))
            flat = {k: (transform(name, k, a) if transform else a)
                    for k, a in arrays.items()}
            del arrays
            out[name] = _from_numpy(template, flat)
        with open(os.path.join(d, "metadata.json")) as f:
            meta = json.load(f)
        return out, meta

    def restore_latest(self, templates: Dict[str, Any]
                       ) -> Tuple[Optional[Dict[str, Any]], Optional[Dict]]:
        """`restore` of the newest step; (None, None) when the directory
        holds no step."""
        step = self.latest_step()
        if step is None:
            return None, None
        return self.restore(step, templates)

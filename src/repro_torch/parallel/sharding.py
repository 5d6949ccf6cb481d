"""The parallel context threaded through the model entry points.

Counterpart of ``ParallelCtx`` in ``repro/parallel/sharding.py``: which
mesh the run sits on, which of its dims carry tensor (model), sequence and
data parallelism, and how far parameters are FSDP-sharded. The mesh is
torch's ``DeviceMesh``; its dim names are the JAX package's. The ctx
computes each dim's width, this rank's coordinate on it and its process
group once, when it is built, and exposes them as :class:`Axis` records,
so callers branch on integer widths and never inspect the mesh. The ctx
compares and hashes by those records, process groups included, and not by
the mesh: torch compares meshes by their layout, so a mesh rebuilt after
the process groups were destroyed and opened again equals the old one,
while its ctx, and every plan cached on it, is a new one.

The sharding rules of the JAX module (``shard_activation``, ``_rules``,
``spec_for_path``, ``param_shardings``) come with sharded training, their
first caller.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

DATA_AXES = ("pod", "data")


class Axis(NamedTuple):
    """One mesh dim as this rank sees it: its name, its width, this rank's
    coordinate along it, and the process group of the ranks that differ
    from this one only along it (compared by identity)."""

    name: str
    width: int
    coord: int
    group: Any


def mesh_axes(mesh) -> Tuple[Axis, ...]:
    """The Axis records of a DeviceMesh (none for None), in mesh order."""
    if mesh is None:
        return ()
    return tuple(Axis(name, mesh.size(i), mesh.get_local_rank(name),
                      mesh.get_group(name))
                 for i, name in enumerate(mesh.mesh_dim_names or ()))


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """Static description of the parallel environment. ``mesh=None`` is a
    single device."""

    mesh: Any = dataclasses.field(default=None, compare=False)
    model_axis: str = "model"
    seq_axis: str = "seq"
    # "none" | "data" | "pod_data" | "experts_data" | "experts_pod_data"
    fsdp: str = "none"
    # data-like axes left out of `data_axes`
    exclude_data_axes: Tuple[str, ...] = ()
    # the mesh's dims (mesh_axes), read once; compared in place of the mesh
    axes: Tuple[Axis, ...] = dataclasses.field(init=False, default=())

    def __post_init__(self):
        object.__setattr__(self, "axes", mesh_axes(self.mesh))

    def axis(self, name: Optional[str]) -> Optional[Axis]:
        """The mesh dim `name`, or None when the mesh lacks it."""
        return next((a for a in self.axes if a.name == name), None)

    def width(self, name: Optional[str]) -> int:
        """Width of dim `name`, 1 when the mesh lacks it."""
        a = self.axis(name)
        return 1 if a is None else a.width

    @property
    def _names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self._names if a in DATA_AXES
                     and a not in self.exclude_data_axes)

    @property
    def fsdp_scope(self) -> str:
        return "moe" if self.fsdp.startswith("experts") else "all"

    @property
    def fsdp_axes(self) -> Tuple[str, ...]:
        if self.fsdp in ("data", "experts_data"):
            return ("data",)
        if self.fsdp in ("pod_data", "experts_pod_data"):
            return tuple(a for a in DATA_AXES
                         if self.mesh is None or a in self._names)
        return ()

    @property
    def has_pod_axis(self) -> bool:
        return "pod" in self._names

    @property
    def model_shards(self) -> int:
        return self.width(self.model_axis)

    @property
    def seq_shards(self) -> int:
        return self.width(self.seq_axis)

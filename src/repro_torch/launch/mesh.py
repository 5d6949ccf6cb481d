"""Meshes over torch.distributed ranks, and their fail-fast checks.

Counterpart of ``repro/launch/mesh.py``: ``make_local_mesh``,
``make_mesh`` (``jax.make_mesh``: any shape and dim names, e.g.
("pod", "data", "model") for the compressed cross-pod step), the
attention-mesh checks ``validate_attention_mesh`` and
``validate_seq_shards`` with the JAX package's messages, and the per-arch
FSDP policy ``ARCH_FSDP`` / ``fsdp_for``, copied. A mesh here is torch's
``DeviceMesh`` over the ranks of the default process group; the dim names
are the JAX package's ("data", "model"), or ("data", "seq", "model") with
a sequence axis. ``mesh_width`` is the JAX helper ``axis_size`` under
another name: callers branch on the widths that ``ParallelCtx`` and
``AttentionPlan`` compute from it, never on the helper itself.

Every group gets an explicit timeout (``GROUP_TIMEOUT``), so a collective
that one rank never joins raises instead of hanging. ``init_ranks`` opens
the default group with it; ``make_local_mesh`` passes it to each mesh
dim's group.

``make_production_mesh`` builds JAX's production shapes, (16, 16) named
("data", "model") or (2, 16, 16) named ("pod", "data", "model"), over a
fake process group (``fake_world``): one process stands for rank 0 of
256 or 512, collectives run on FakeTensors and move nothing. The dry run
(launch/dryrun.py) and the trace audit (analysis/trace_audit.py) use it;
``H100_*`` are the card's datasheet rates the dry run's roofline divides
by; ``link_rates`` gives each mesh dim the rate of the link its
collectives cross (NVLink inside a node of 8 cards, InfiniBand between
nodes).
"""
from __future__ import annotations

import contextlib
import datetime
import warnings
from typing import Dict, Iterator, Optional, Sequence

import torch.distributed as dist

GROUP_TIMEOUT = datetime.timedelta(seconds=120)

# NVIDIA's datasheet figures for one H100 80GB HBM3 SXM at its 700 W limit
# (dense rates, no sparsity), not measurements: the dry run's roofline
# terms divide by them, and chip_smoke.py's kernel bounds too.
H100_FLOPS_BF16 = 989e12          # FLOP/s, bf16 on the tensor cores
H100_HBM_BYTES_PER_S = 3.35e12    # B/s
H100_NVLINK_BYTES_PER_S = 450e9   # B/s per direction (NVLink 4, 18 links)
# An HGX/DGX H100 node holds 8 cards on NVLink; between nodes each card has
# one 400 Gb/s InfiniBand NDR port (ConnectX-7), NVIDIA's DGX H100
# datasheet: 50 GB/s a card per direction.
H100_NODE_CARDS = 8
H100_IB_BYTES_PER_S = 50e9        # B/s per direction a card


def link_rates(shape: Sequence[int], names: Sequence[str]
               ) -> Dict[str, float]:
    """Each mesh dim's per-card link rate, ranks laid out row-major (as
    ``init_device_mesh`` lays them) H100_NODE_CARDS to a node: NVLink where
    the dim's groups lie inside one node (its width times the widths of
    the dims after it divides the node), InfiniBand where they cross."""
    rates, span = {}, 1
    for name, width in reversed(list(zip(names, shape))):
        span *= width
        rates[name] = (H100_NVLINK_BYTES_PER_S if H100_NODE_CARDS % span == 0
                       else H100_IB_BYTES_PER_S)
    return rates


def init_ranks(backend: str, init_method: str, rank: int, world_size: int,
               timeout: datetime.timedelta = GROUP_TIMEOUT) -> None:
    """Open the default process group with an explicit timeout."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)


def _group_options(backend: str, timeout: datetime.timedelta):
    if backend == "gloo":
        opts = dist.ProcessGroupGloo._Options()
    else:
        opts = dist.ProcessGroupNCCL.Options()
    opts._timeout = timeout
    return opts


def _init_device_mesh(device_type: str, shape, names,
                      timeout: datetime.timedelta):
    """torch's init_device_mesh with each dim's group on the default
    group's backend and `timeout` (a fake group has neither to set)."""
    from torch.distributed.device_mesh import init_device_mesh
    backend = dist.get_backend()
    if backend == "fake":
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    opts = _group_options(backend, timeout)
    return init_device_mesh(device_type, shape, mesh_dim_names=names,
                            backend_override={a: (backend, opts)
                                              for a in names})


def make_local_mesh(model_shards: int = 1, seq_shards: int = 1, *,
                    device_type: str,
                    timeout: datetime.timedelta = GROUP_TIMEOUT):
    """A DeviceMesh over every rank of the default group: "model" is the
    tensor-parallel width, "seq" the sequence-parallel one, the rest goes
    to "data". With seq_shards == 1 the mesh has JAX's 2-axis ("data",
    "model") shape. Collective over the world: every rank calls it."""
    n = dist.get_world_size()
    if n % (model_shards * seq_shards) != 0:
        raise ValueError(f"{n} ranks do not divide into model_shards="
                         f"{model_shards} x seq_shards={seq_shards}")
    if seq_shards == 1:
        shape = (n // model_shards, model_shards)
        names = ("data", "model")
    else:
        shape = (n // (model_shards * seq_shards), seq_shards, model_shards)
        names = ("data", "seq", "model")
    return _init_device_mesh(device_type, shape, names, timeout)


@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """A fake default process group of `world_size` ranks, this process
    rank 0, for the block: meshes built inside it cost nothing, and
    collectives on FakeTensors run without moving a byte. The group is
    process-global, so it is destroyed on exit, also after an error."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process without a default "
                           "process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False, device_type: str):
    """JAX's production mesh over the default group, which must have 256
    (or, `multi_pod`, 512) ranks: (16, 16) named ("data", "model"), or
    (2, 16, 16) named ("pod", "data", "model"). Inside ``fake_world`` no
    machine needs that many cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, names, device_type=device_type)


def make_mesh(shape, names, *, device_type: str,
              timeout: datetime.timedelta = GROUP_TIMEOUT):
    """A DeviceMesh of `shape` with dim `names` over every rank of the
    default group (the counterpart of ``jax.make_mesh``); the product of
    `shape` must be the world size. Collective over the world."""
    shape, names = tuple(shape), tuple(names)
    n = 1
    for w in shape:
        n *= w
    if n != dist.get_world_size() or len(shape) != len(names):
        raise ValueError(f"mesh {dict(zip(names, shape))} does not cover "
                         f"the {dist.get_world_size()} ranks")
    return _init_device_mesh(device_type, shape, names, timeout)


def mesh_width(mesh, axis: Optional[str]) -> int:
    """Width of `axis` in `mesh`: 1 if the mesh lacks it (or is None)."""
    names = () if mesh is None else (mesh.mesh_dim_names or ())
    if axis not in names:
        return 1
    return mesh.size(names.index(axis))


def validate_attention_mesh(mesh, *, num_heads: int, num_kv_heads: int,
                            model_axis: str = "model",
                            strict: bool = False) -> bool:
    """Whether the mesh can head-shard the attention kernels: the
    tensor-parallel width must divide Hkv (each shard keeps whole GQA
    groups). When it does not, ``strict=True`` raises; the default warns
    and returns False (the model axis is shared with expert parallelism,
    so the plan drops the head sharding instead of failing)."""
    if num_heads % num_kv_heads != 0:
        raise ValueError(f"num_heads={num_heads} is not a multiple of "
                         f"num_kv_heads={num_kv_heads}")
    tp = mesh_width(mesh, model_axis)
    if num_kv_heads % tp == 0:
        return True
    msg = (
        f"mesh axis {model_axis!r} has {tp} shards, which does not divide "
        f"num_kv_heads={num_kv_heads}: the fused attention kernels shard "
        f"the KV-head axis, so every shard needs whole KV heads. Use a "
        f"tensor-parallel width that divides {num_kv_heads}, or raise "
        f"num_kv_heads.")
    if strict:
        raise ValueError(msg)
    warnings.warn(msg + " Falling back to unsharded fused attention "
                  "(GSPMD) on this mesh.", stacklevel=2)
    return False


def validate_seq_shards(seq_len: int, block_size: int, sp: int,
                        seq_axis: str = "seq") -> None:
    """Fail fast when a sequence length cannot shard over the sequence
    axis: each shard must hold a whole number of attention blocks."""
    if seq_len % (sp * block_size) != 0:
        raise ValueError(
            f"sequence length {seq_len} cannot shard over mesh axis "
            f"{seq_axis!r} ({sp} shards): each shard must hold a whole "
            f"number of {block_size}-token attention blocks, i.e. S must be "
            f"a multiple of sp·c = {sp * block_size}. Pad the sequence or "
            f"change the mesh.")


# Per-arch FSDP policy: how far parameters/optimizer state are sharded over
# the data-like axes (the JAX package's table).
ARCH_FSDP = {
    "qwen3-8b": "data",
    "qwen3-14b": "data",
    "nemotron-4-15b": "data",
    "qwen1.5-110b": "data",
    "kimi-k2-1t-a32b": "pod_data",
    "qwen3-moe-30b-a3b": "data",
    "internvl2-2b": "none",
    "zamba2-1.2b": "none",
    "musicgen-large": "none",
    "rwkv6-1.6b": "none",
    "linformer-paper": "none",
}


def fsdp_for(arch: str, multi_pod: bool) -> str:
    f = ARCH_FSDP.get(arch, "none")
    if f == "pod_data" and not multi_pod:
        return "data"
    return f

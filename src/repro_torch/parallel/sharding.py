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

The sharding rules are the JAX module's (``_rules``, ``spec_for_path``,
``param_shardings``): a spec is a tuple with one entry per dim, None, a
mesh dim's name or a tuple of names (the first major), JAX's
``PartitionSpec`` as a plain tuple. The port lays a tensor out per its
spec as a LOCAL view: each rank stores only its slice (:func:`shard_leaf`,
:func:`shard_tree`) and makes a leaf whole where it is used
(:func:`unshard_leaf`), through parallel/comm.py's autograd collectives:

* over a dim the batch splits on (``ctx.data_axes``), all-gather; the
  gradient is summed over those ranks, then sliced (FSDP's
  reduce-scatter, as an all-reduce and a slice);
* over another dim (the model dim), all-gather; the gradient is sliced
  with no sum, since every such rank computes the same thing where the
  whole leaf is used;
* over a data dim the leaf is not sharded on, ``comm.copy``: its gradient
  sums over the ranks that hold other rows.

A ctx with ``sharded=True`` is the training layout: every rank holds its
rows of the batch over ``data_axes`` (:func:`shard_activation`, JAX's
default activation spec) and its shard of each parameter and moment; the
model entry points then gather a layer's FSDP dims inside the layer loop
and run the plan's regions and the MoE layer on :func:`region_ctx`, whose
data dims are excluded (JAX's ``exclude_data_axes`` mechanism), so a
region splits over tp and sp only. The model dim of a leaf stays on this
rank's shard there (:func:`tp_keep`): tensor parallelism, Megatron-style,
as GSPMD partitions JAX's steps by the same specs (models/layers.py,
models/attention.py, the vocabulary-parallel head of
models/transformer.py and the cross-entropy of models/model.py, and
Mamba2's and RWKV6's blocks on this rank's heads, :func:`head_range`,
models/mamba2.py and models/rwkv6.py).

The vocabulary dim (``embed/tok``'s rows, ``lm_head``'s columns) may split
unevenly over the model dim (:func:`dim_range`: ceil(V / tp) a rank, the
last ranks shorter); every other dim must divide.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.parallel import comm

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
    # the training layout: local rows over data_axes and parameter shards
    # per param_shardings (see the module docstring)
    sharded: bool = False
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


def is_sharded(ctx: Optional[ParallelCtx]) -> bool:
    """Whether `ctx` asks for the training layout on a mesh."""
    return ctx is not None and ctx.mesh is not None and ctx.sharded


def region_ctx(ctx: Optional[ParallelCtx]) -> Optional[ParallelCtx]:
    """The ctx the plan's regions and the MoE layer run on: under the
    training layout the batch is local already, so the data dims are
    excluded; any other ctx is returned as is."""
    if not is_sharded(ctx):
        return ctx
    return dataclasses.replace(ctx, exclude_data_axes=DATA_AXES,
                               sharded=False)


# ---------------------------------------------------------------------------
# Parameter sharding rules (copied from the JAX module)
# ---------------------------------------------------------------------------

Spec = Tuple[Any, ...]


def _rules(fsdp):
    F = fsdp if fsdp else None      # tuple of axes or None
    return [
        # embeddings / lm head: vocab over model, d_model over fsdp
        (r"(^|/)embed/tok$", ("model", F)),
        (r"(^|/)embed/pos$", (None, F)),
        (r"(^|/)lm_head$", (F, "model")),
        # attention projections (leading L when stacked)
        (r"attn/wq$", (None, F, "model")),
        (r"attn/wk$", (None, F, "model")),
        (r"attn/wv$", (None, F, "model")),
        (r"attn/wo$", (None, "model", F)),
        (r"attn/b[qkv]$", (None, "model")),
        # dense MLP
        (r"mlp/w_in$", (None, F, "model")),
        (r"mlp/w_gate$", (None, F, "model")),
        (r"mlp/w_out$", (None, "model", F)),
        # MoE: experts over model (EP), hidden over fsdp
        (r"moe/router$", (None, F, None)),
        (r"moe/w_in$", (None, "model", F, None)),
        (r"moe/w_gate$", (None, "model", F, None)),
        (r"moe/w_out$", (None, "model", None, F)),
        # mamba2 / rwkv6 big projections
        (r"ssm/w_in$", (None, F, "model")),
        (r"ssm/w_out$", (None, "model", F)),
        (r"rwkv/w_(r|k|v|g)$", (None, F, "model")),
        (r"rwkv/w_o$", (None, "model", F)),
        (r"rwkv/cm_w_k$", (None, F, "model")),
        (r"rwkv/cm_w_v$", (None, "model", F)),
        (r"rwkv/cm_w_r$", (None, F, "model")),
        # shared (unstacked) attention/mlp block (zamba2): no L axis
        (r"shared_block/attn/w[qkv]$", (F, "model")),
        (r"shared_block/attn/wo$", ("model", F)),
        (r"shared_block/mlp/w_(in|gate)$", (F, "model")),
        (r"shared_block/mlp/w_out$", ("model", F)),
        # linformer E/F and everything small: replicated
    ]


def spec_for_path(path: str, fsdp_axes: Sequence[str], ndim: int,
                  fsdp_scope: str = "all") -> Spec:
    """The spec of the leaf at `path` (its "/"-joined key) of rank `ndim`:
    the first rule that matches, trimmed from the front or padded with
    None to the rank, 1-tuples as bare names; replicated by default."""
    fsdp = tuple(fsdp_axes) if fsdp_axes else None
    if fsdp_scope == "moe" and not re.search(r"(^|/)(moe|embed|lm_head)",
                                             path):
        fsdp = None
    for pat, spec in _rules(fsdp):
        if re.search(pat, path):
            parts = list(spec)
            if len(parts) > ndim:
                parts = parts[len(parts) - ndim:]
            while len(parts) < ndim:
                parts.append(None)
            return tuple(p[0] if isinstance(p, tuple) and len(p) == 1
                         else p for p in parts)
    return (None,) * ndim


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _nest(flat: Dict[str, Any]) -> Dict:
    out: Dict = {}
    for key, val in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def leaf_spec(path: str, ndim: int, ctx: ParallelCtx) -> Spec:
    return spec_for_path(path, ctx.fsdp_axes, ndim, ctx.fsdp_scope)


def param_shardings(params: Dict, ctx: ParallelCtx) -> Dict:
    """The spec of every leaf of `params` (a nested dict of tensors, or of
    anything with ``ndim`` or ``shape``), as a nested dict of the same
    structure."""
    return _nest({k: leaf_spec(k, len(v.shape), ctx)
                  for k, v in _flatten(params).items()})


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _live(ctx: ParallelCtx, names) -> Tuple[Axis, ...]:
    return tuple(a for a in (ctx.axis(n) for n in names)
                 if a is not None and a.width > 1)


def sharded_axes(spec: Spec, ctx: ParallelCtx) -> Tuple[Axis, ...]:
    """The mesh dims wider than 1 that `spec` splits a tensor over."""
    return tuple(a for entry in spec for a in _live(ctx, _names(entry)))


def dim_range(n: int, axes) -> Tuple[int, int]:
    """This rank's [start, stop) of a dim of size `n` split over `axes`
    (Axis records, the first major): ceil(n / w) indices a rank, so the
    last ranks hold fewer (or none) where the width w does not divide n,
    as GSPMD lays out an uneven dim (without its padding)."""
    w = comm.flat_width(axes)
    m = -(-n // w)
    i = comm.flat_coord(axes)
    return min(i * m, n), min((i + 1) * m, n)


_VOCAB = r"(^|/)(embed/tok|lm_head)$"


def is_vocab_leaf(path: str) -> bool:
    """Whether `path` is a leaf with a vocabulary dim (``embed/tok``,
    ``lm_head``), the one dim that may split unevenly."""
    return re.search(_VOCAB, path) is not None


def shard_slices(shape, spec: Spec, ctx: ParallelCtx, uneven: bool = False
                 ) -> Tuple[slice, ...]:
    """The index of this rank's slice of a `shape` tensor laid out per
    `spec`; raises when a dim does not split evenly, but for a dim split
    over the model dim alone with `uneven` (a vocabulary, see
    :func:`dim_range`)."""
    out = []
    for dim, (n, entry) in enumerate(zip(shape, spec)):
        axes = _live(ctx, _names(entry))
        w = comm.flat_width(axes)
        if n % w != 0 and not (uneven and _names(entry) == (ctx.model_axis,)):
            raise ValueError(f"dim {dim} of size {n} does not split over "
                             f"{w} shards")
        out.append(slice(*dim_range(n, axes)))
    return tuple(out)


def leaf_slices(path: str, shape, ctx: ParallelCtx) -> Tuple[slice, ...]:
    """`shard_slices` of the leaf at `path` of a `shape` tensor, per its
    spec; the vocabulary may split unevenly."""
    return shard_slices(shape, leaf_spec(path, len(shape), ctx), ctx,
                        uneven=is_vocab_leaf(path))


def shard_leaf(x: torch.Tensor, spec: Spec, ctx: ParallelCtx,
               uneven: bool = False) -> torch.Tensor:
    """This rank's slice of the whole tensor `x` per `spec`, as a tensor
    of its own (the whole one can be freed)."""
    y = x.detach()[shard_slices(x.shape, spec, ctx, uneven)]
    return y.clone(memory_format=torch.contiguous_format)


def shard_tree(tree: Dict, ctx: ParallelCtx) -> Dict:
    """Every leaf of `tree` (parameters, or moments keyed like them)
    replaced by this rank's shard per `param_shardings`."""
    return _nest({k: shard_leaf(v, leaf_spec(k, v.ndim, ctx), ctx,
                                is_vocab_leaf(k))
                  for k, v in _flatten(tree).items()})


def gather_dim(x: torch.Tensor, dim: int, axis, n: Optional[int] = None
               ) -> torch.Tensor:
    """``comm.gather`` of `dim` over `axis` into its whole size `n`
    (default: the width times this shard's size), where the shards may be
    uneven (:func:`dim_range`): each is padded to ceil(n / w) first and
    the padding dropped after. Differentiable as comm.gather."""
    if axis is None or axis.width == 1:
        return x
    if n is None or n % axis.width == 0:
        return comm.gather(x, dim, (axis,))
    m = -(-n // axis.width)
    pad = [0, 0] * (x.ndim - 1 - dim % x.ndim) + [0, m - x.shape[dim]]
    return comm.gather(torch.nn.functional.pad(x, pad), dim,
                       (axis,)).narrow(dim, 0, n)


def unshard_leaf(x: torch.Tensor, spec: Spec, ctx: ParallelCtx,
                 keep: Tuple[str, ...] = (), shape=None) -> torch.Tensor:
    """The whole tensor from this rank's shard `x` (laid out per `spec`),
    differentiable with the gradient rules of the module docstring. The
    mesh dims named in `keep` stay sharded (:func:`tp_keep`). `shape`,
    the whole tensor's, is needed where the model dim splits unevenly
    (a vocabulary)."""
    summed = ctx.data_axes
    used = set()
    for dim, entry in enumerate(spec):
        for name in reversed(_names(entry)):
            used.add(name)
            a = ctx.axis(name)
            if a is None or a.width == 1 or name in keep:
                continue
            if name in summed:
                x = comm.all_gather_tiled(x, dim, a)
            else:
                x = gather_dim(x, dim, a,
                               None if shape is None else shape[dim])
    return comm.copy(x, [ctx.axis(n) for n in summed if n not in used])


# the leaves whose model dim tensor parallelism keeps on its shard inside
# the block: every leaf whose rule names "model" but, on the gathered
# routes, Mamba2's and RWKV6's (where the model width does not divide
# their heads) and the KV projections (where it does not divide the KV
# heads); see tp_keep
_SSM = r"(^|/)(ssm|rwkv)/"
_KV = r"attn/(wk|wv|bk|bv)$"


def tp_keep(path: str, ctx: ParallelCtx, whole_kv: bool = False,
            whole_ssm: bool = False) -> Tuple[str, ...]:
    """The dims `unshard_leaf` keeps sharded for the block's compute under
    the training layout: the model dim of a leaf whose rule names it
    (column- and row-parallel weights, the vocabulary, MoE expert
    stacks, Mamba2's and RWKV6's projections), but for the leaves of a
    gathered route, which are gathered whole: with `whole_ssm` (the model
    width does not divide the Mamba2 or RWKV6 heads, see
    :func:`head_range`) every ``ssm/`` and ``rwkv/`` leaf, and with
    `whole_kv` (it does not divide the KV heads: the whole-head route of
    models/attention.py) ``wk``/``wv``/``bk``/``bv``."""
    if (whole_ssm and re.search(_SSM, path)) or \
            (whole_kv and re.search(_KV, path)):
        return ()
    return (ctx.model_axis,)


def unshard_tree(tree: Dict, ctx: ParallelCtx, prefix: str = "",
                 drop: int = 0, keep_for=None) -> Dict:
    """`unshard_leaf` of every leaf of `tree`, whose keys sit under
    `prefix` in the parameter tree; `drop` leading spec entries are
    left out (a layer's views of layer-stacked leaves drop the layer
    axis). `keep_for(path)` names the dims a leaf keeps sharded (`path`
    its whole key)."""
    out = {}
    for k, v in _flatten(tree).items():
        spec = leaf_spec(prefix + k, v.ndim + drop, ctx)[drop:]
        out[k] = unshard_leaf(v, spec, ctx,
                              keep_for(prefix + k) if keep_for else ())
    return _nest(out)


def tensor_axis(ctx: Optional[ParallelCtx]):
    """The model dim's Axis where tensor parallelism runs: under the
    training layout with a model dim wider than 1; else None."""
    if not is_sharded(ctx) or ctx.model_shards == 1:
        return None
    return ctx.axis(ctx.model_axis)


def head_range(heads: int, tp) -> Optional[Tuple[int, int]]:
    """This rank's [lo, hi) of a block's `heads` (Mamba2's or RWKV6's)
    over the model dim `tp` (its Axis, :func:`tensor_axis`): heads / width
    contiguous heads a rank, so a column- or row-parallel shard of a
    head-major dim is exactly this rank's heads. None without tensor
    parallelism or where the width does not divide the heads: the gathered
    route, on which the block runs on whole leaves (tp_keep's
    `whole_ssm`)."""
    if tp is None or heads % tp.width != 0:
        return None
    n = heads // tp.width
    return tp.coord * n, (tp.coord + 1) * n


def heads_axis(heads: int, ctx: Optional[ParallelCtx]
               ) -> Tuple[Optional[Axis], bool]:
    """(the model dim's Axis a Mamba2 or RWKV6 block of `heads` heads runs
    tensor-parallel on, or None; whether it takes the gathered route:
    tensor parallelism on a model width that does not divide the
    heads, tp_keep's `whole_ssm`)."""
    tp = tensor_axis(ctx)
    if tp is None or head_range(heads, tp) is not None:
        return tp, False
    return None, True


def mamba_in_columns(d_inner: int, state: int, head_dim: int,
                     heads: Tuple[int, int]) -> Dict[str, range]:
    """The columns of Mamba2's whole ``ssm/w_in``, laid out [z (d_inner) |
    x (d_inner) | B (N) | C (N) | dt (H)], that the heads [lo, hi) read:
    their z, x and dt columns, and all of B and C (one group, which every
    head reads), by segment."""
    lo, hi = heads
    a, b = lo * head_dim, hi * head_dim
    bc = 2 * d_inner
    dt = bc + 2 * state
    return {"z": range(a, b), "x": range(d_inner + a, d_inner + b),
            "B": range(bc, bc + state), "C": range(bc + state, dt),
            "dt": range(dt + lo, dt + hi)}


def take_columns(y: torch.Tensor, cols: Sequence[range]) -> torch.Tensor:
    """The columns `cols` (ranges, in order) of y's last dim, adjacent
    ranges taken as one slice."""
    runs = []
    for r in cols:
        if runs and runs[-1][1] == r.start:
            runs[-1][1] = r.stop
        else:
            runs.append([r.start, r.stop])
    parts = [y[..., a:b] for a, b in runs]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def column_matmul(x: torch.Tensor, w: torch.Tensor, tp,
                  cols: Optional[Sequence[range]] = None) -> torch.Tensor:
    """``x @ W[:, cols]``, W the whole leaf whose column shard over the
    model dim `tp` (W/tp contiguous columns) this rank holds as `w`, for
    the column-parallel leaves whose shard does not line up with the
    work: Mamba2's ``ssm/w_in`` (`cols`: this rank's z, x and dt and all
    of B and C, :func:`mamba_in_columns`; the product feeds this rank's
    heads alone, so x enters through ``comm.copy``) and RWKV6's
    ``cm_w_r`` (`cols` None: every column, the gate of the whole-width
    output, which every model rank then uses alike; x as is).

    One of the two moves over the model dim, whichever is smaller (both
    give the same values): the weight route gathers W (D × W from the
    ranks, its gradient summed over them where the ranks read different
    columns) and multiplies by the columns wanted; the activation route
    multiplies by the shard, as GSPMD does, gathers the output (rows × W)
    and takes the columns. The rule: the weight route where the whole
    weight's bytes are at most the whole output's, D·size(w) ≤
    rows·size(x), i.e. a training or prefill step of at least D tokens a
    rank; a decode step of a few rows takes the activation route."""
    rows = x.numel() // x.shape[-1]
    weight_route = w.shape[0] * w.element_size() <= rows * x.element_size()
    if cols is None:
        if weight_route:
            return x @ comm.gather(w, w.ndim - 1, (tp,))
        y = comm.copy(x, (tp,)) @ w
        return comm.gather(y, y.ndim - 1, (tp,))
    x = comm.copy(x, (tp,))
    if weight_route:
        return x @ take_columns(comm.all_gather_tiled(w, w.ndim - 1, tp),
                                 cols)
    y = x @ w
    return take_columns(comm.all_gather_tiled(y, y.ndim - 1, tp), cols)


def sharded_lookup(table: torch.Tensor, tokens: torch.Tensor,
                   ctx: ParallelCtx, path: str = "embed/tok",
                   vocab: Optional[int] = None) -> torch.Tensor:
    """Rows `tokens` (this rank's, over the data dims) of an embedding
    table stored as this rank's shard per its spec (vocab over the model
    dim, d_model over the fsdp dims), without making the table whole: the
    data ranks' tokens are all-gathered, each rank looks up the ones in its
    vocab slice for its d_model slice, the parts are summed over the model
    dim (``comm.reduce``: every model rank then computes alike) and
    gathered over the fsdp dims (``comm.all_gather_tiled``: the gradient
    of a rank's slice sums every data rank's tokens), and this rank keeps
    its own rows. The value and gradient are those of a lookup in the
    whole table; the bytes moved are the looked-up rows, not the table.
    `vocab`, the table's whole row count, places an uneven shard
    (:func:`dim_range`; default: the shards are even)."""
    spec = leaf_spec(path, table.ndim, ctx)
    vocab_axes = _live(ctx, _names(spec[0]))
    cols = _live(ctx, _names(spec[1]))
    data = [ctx.axis(n) for n in ctx.data_axes]
    # a data dim the table is not split on sums its gradient (as in
    # unshard_leaf): its ranks look up other rows
    table = comm.copy(table, [a for a in data if a not in cols])
    shape = tokens.shape
    toks = tokens.reshape(-1).long()
    for a in reversed(_live(ctx, ctx.data_axes)):     # the first major
        toks = comm.all_gather_stack(toks, a).reshape(-1)
    rows = table.shape[0]
    start = comm.flat_coord(vocab_axes) * rows if vocab is None \
        else dim_range(vocab, vocab_axes)[0]
    local = toks - start
    hit = (local >= 0) & (local < rows)
    part = table[local.clamp(0, rows - 1)] * hit[:, None].to(table.dtype)
    x = comm.reduce(part, vocab_axes)
    for a in reversed(cols):
        x = comm.all_gather_tiled(x, 1, a)
    n = toks.shape[0] // comm.flat_width(data)
    x = x.narrow(0, comm.flat_coord(data) * n, n)
    return x.reshape(*shape, x.shape[-1])


def shard_activation(x: torch.Tensor, ctx: Optional[ParallelCtx],
                     spec: Optional[Spec] = None) -> torch.Tensor:
    """This rank's view of an input laid out per `spec` (default: the
    batch over the data dims, the rest whole), a view of `x`; no-op
    without a mesh. JAX constrains a global array's layout; the port
    takes the local slice of a tensor every rank holds whole."""
    if ctx is None or ctx.mesh is None:
        return x
    if spec is None:
        spec = (ctx.data_axes or None,) + (None,) * (x.ndim - 1)
    return x[shard_slices(x.shape, spec, ctx)]

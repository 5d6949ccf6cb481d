"""Mixture-of-Experts feed-forward with capacity-based dispatch.

Counterpart of ``repro/models/moe.py``. Each token picks its top-k experts
by router probability; expert e keeps at most C = capacity(T) tokens, in
row-major token order over the whole flattened (B·S) batch, and drops the
rest, so one row's output depends on every other row of the same call.

Expert parallelism (``apply_moe`` with a ctx whose model dim is wider than
1): the experts shard over the model dim, each model rank owning
E/model_shards of them. Activations are replicated over the model dim,
so each rank routes its tokens against all experts, runs only its own,
and one sum over the model dim (``comm.reduce``) combines them, with no
all-to-all: the JAX module's shard_map branch. The tokens split over the
data dims when those divide B·S (replicated otherwise), and capacity is
then computed from a shard's local token count, as in JAX; the aux loss
is averaged over the region's dims. At decode (S == 1, the config's
``weight_stationary_decode``), :func:`_moe_weight_stationary` keeps the
expert weights split over model × fsdp instead and moves the (tiny)
tokens: two fsdp psums of h and g, one model sum, one fsdp all-gather.
The collectives are parallel/comm.py's autograd Functions, so both paths
are differentiable. Each rank holds the whole input (its own rows under
the training layout, whose data dims the caller's ctx excludes) and the
whole params, but for the expert stacks of the training layout, which
arrive as this rank's model shard and are used as they are. Under that
layout the rows differ from one data rank to the next, so a decode step
there (``decode_step`` of models/transformer.py with a sharded ctx) takes
the expert-parallel path on each rank's rows, not the weight-stationary
one, which needs the same tokens on every fsdp rank.

The routing is JAX's to the bit where fp32 allows: the router runs in fp32
whatever the model dtype, ties between equal probabilities go to the lower
expert index (``jax.lax.top_k``'s order; a stable descending sort), and a
token's slot in an expert is its rank among the expert's tokens. Dispatch
and combine never build an (E, T, D) tensor: each (token, choice) pair
writes its token to a unique (expert, slot) row, or to one overflow row
that is thrown away, and the combine gathers each token's ≤ k expert
outputs, scales them by the renormalised weight (cast to the output dtype,
as JAX casts it) and sums them in ascending expert order. The experts'
loads are integer column sums of the (T, E) choice mask, with a static
shape (the dry run's FakeTensors take no data-dependent shape), and the
forward is deterministic on the card.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as Fn

from repro_torch.configs.base import MLPConfig, MoEConfig
from repro_torch.parallel import comm


def moe_param_shapes(d_model: int, cfg: MoEConfig, mlp: MLPConfig,
                     dtype: torch.dtype
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """One layer's {leaf: (shape, dtype)}: the router (D, E) in fp32
    whatever the model `dtype`, the experts' (E, D, ff) w_in and w_gate
    (swiglu only) and (E, ff, D) w_out in `dtype`. All are fan-in normal
    with shape[-2] as the fan-in (JAX's ``init_moe``)."""
    E, ff = cfg.num_experts, cfg.expert_d_ff
    shapes = {"router": ((d_model, E), torch.float32),
              "w_in": ((E, d_model, ff), dtype),
              "w_out": ((E, ff, d_model), dtype)}
    if mlp.activation == "swiglu":
        shapes["w_gate"] = ((E, d_model, ff), dtype)
    return shapes


def capacity(tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert keeps for a call over `tokens` tokens: the top-k
    share of the tokens times capacity_factor, at least 1 (or top_k with
    ``capacity_floor_one=False``)."""
    c = int(tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    floor = 1 if cfg.capacity_floor_one else cfg.top_k
    return max(floor, c)


def expert_ffn(w_in: torch.Tensor, w_gate: Optional[torch.Tensor],
               w_out: torch.Tensor, x: torch.Tensor, activation: str
               ) -> torch.Tensor:
    """x: (E, C, D) -> (E, C, D), each expert's MLP over its slots."""
    h = torch.bmm(x, w_in)
    if activation == "swiglu":
        h = Fn.silu(torch.bmm(x, w_gate)) * h
    elif activation == "squared_relu":
        h = torch.square(torch.relu(h))
    elif activation == "gelu":
        h = Fn.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return torch.bmm(h, w_out)


def route(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig
          ) -> Dict[str, torch.Tensor]:
    """Routing of tokens x (T, D) over the experts of `router` (D, E):

    * ``top_i`` (T, k) chosen experts, by the fp32 softmax of the fp32
      router logits, ties to the lower index; ``top_w`` (T, k) their
      probabilities renormalised to sum 1;
    * ``slot`` (T, k) each choice's rank among its expert's tokens (row-
      major token order) and ``keep`` (T, k) whether it is within the
      capacity C = capacity(T);
    * ``aux``: the Switch load-balance loss E · Σ_e f_e · p_e, f_e the
      share of the T·k choices on expert e, p_e its mean probability."""
    T = x.shape[0]
    E, K = router.shape[1], cfg.top_k
    C = capacity(T, cfg)
    logits = x.to(torch.float32) @ router
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :K], top_i[:, :K]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    chosen = torch.zeros((T, E), dtype=torch.int32, device=x.device)
    chosen.scatter_(1, top_i, 1)
    # a token's k choices are distinct experts: each expert's load is its
    # column's sum (a static shape, where bincount's depends on the data)
    counts = chosen.sum(0)
    aux = E * torch.sum(probs.mean(0) * (counts.to(torch.float32)
                                         / (T * K)))
    slot = (torch.cumsum(chosen, dim=0) - 1).gather(1, top_i)
    return {"top_i": top_i, "top_w": top_w, "slot": slot, "keep": slot < C,
            "aux": aux, "capacity": C}


def _dispatch(r: Dict[str, torch.Tensor], x: torch.Tensor, n_experts: int,
              e_offset: int):
    """The (n_experts, C, D) slot buffer of experts e_offset ..
    e_offset + n_experts - 1 from routing `r` of tokens x (T, D), with each
    (token, choice)'s buffer row (`dest`, the overflow row n_experts·C for
    a dropped or non-local choice) and its combine weight."""
    T, D = x.shape
    K, C = r["top_i"].shape[1], r["capacity"]
    # order each token's choices by expert index: the combine then sums in
    # JAX's order (a sum over e = 0..E-1 of zeros and the kept outputs)
    top_i, order = torch.sort(r["top_i"], dim=-1)
    top_w, slot, keep = (r[k].gather(1, order)
                         for k in ("top_w", "slot", "keep"))
    local = top_i - e_offset
    keep = keep & (local >= 0) & (local < n_experts)
    # row e·C + slot of the (E·C + 1, D) buffer, or the overflow row E·C
    dest = torch.where(keep, local * C + slot,
                       torch.full_like(top_i, n_experts * C)).reshape(-1)
    tok = torch.arange(T, device=x.device).repeat_interleave(K)
    buf = x.new_zeros((n_experts * C + 1, D)).index_copy(0, dest, x[tok])
    return buf[:n_experts * C].view(n_experts, C, D), dest, top_w * keep


def _combine(y: torch.Tensor, dest: torch.Tensor, w: torch.Tensor
             ) -> torch.Tensor:
    """Each token's kept expert outputs from y (E_loc, C, D), scaled by
    their weights (cast to the output dtype, as JAX casts them) and
    summed: (T, D)."""
    T, K = w.shape
    D = y.shape[-1]
    y = torch.cat([y.reshape(-1, D), y.new_zeros((1, D))])
    return (y[dest].view(T, K, D) * w.to(y.dtype)[..., None]).sum(1)


def moe_local(router: torch.Tensor, w_in: torch.Tensor,
              w_gate: Optional[torch.Tensor], w_out: torch.Tensor,
              x: torch.Tensor, *, cfg: MoEConfig, activation: str,
              e_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route tokens x (T, D) over every expert of `router` (D, E) and run
    the local ones: w_in (E_loc, D, ff) holds experts e_offset ..
    e_offset + E_loc - 1 (all of them by default). Returns (out (T, D),
    aux): out sums the local experts' outputs only."""
    r = route(router, x, cfg)
    buf, dest, w = _dispatch(r, x, w_in.shape[0], e_offset)
    y = expert_ffn(w_in, w_gate, w_out, buf, activation)
    return _combine(y, dest, w), r["aux"]


def _mean_over(aux: torch.Tensor, axes) -> torch.Tensor:
    """aux averaged over the ranks of `axes`: each rank's share of the
    gradient is 1/N of the mean's (comm.reduce passes it through)."""
    return comm.reduce(aux.reshape(1), axes)[0] / comm.flat_width(axes)


def _moe_weight_stationary(params: Dict, xt: torch.Tensor, cfg: MoEConfig,
                           act: str, ctx) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Decode-time expert parallelism where tokens move and weights stay
    put: expert weights split E over the model dim and D over the fsdp
    dims, tokens (B·S = T, tiny) replicated. Per call: two (E_loc, C, ff)
    psums of h and g over fsdp, one (T, D_loc) sum over model and a
    (T, D) all-gather over fsdp."""
    T, D = xt.shape
    maxis = ctx.axis(ctx.model_axis)
    fsdp = tuple(ctx.axis(a) for a in ctx.fsdp_axes
                 if ctx.axis(a) is not None)
    nf = comm.flat_width(fsdp)
    if D % nf != 0:
        raise ValueError(f"d_model={D} does not split over the {nf} fsdp "
                         "shards of weight-stationary decode")
    region = (maxis,) + fsdp
    E_loc = cfg.num_experts // maxis.width
    w_gate = params.get("w_gate")

    def weight(w, d_dim):
        return comm.split(comm.split(w, 0, (maxis,)), d_dim, fsdp)

    x_full = comm.copy(xt, region)
    router = comm.copy(params["router"], region)
    w_in, w_out = weight(params["w_in"], 1), weight(params["w_out"], 2)
    D_loc = D // nf
    x_slice = x_full.narrow(1, comm.flat_coord(fsdp) * D_loc, D_loc)
    r = route(router, x_full, cfg)
    buf, dest, w = _dispatch(r, x_slice, E_loc, maxis.coord * E_loc)
    h = comm.psum(torch.bmm(buf, w_in), fsdp)     # partial over D_loc
    if act == "swiglu":
        g = comm.psum(torch.bmm(buf, weight(w_gate, 1)), fsdp)
        h = Fn.silu(g) * h
    elif act == "squared_relu":
        h = torch.square(torch.relu(h))
    elif act == "gelu":
        h = Fn.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {act!r}")
    out = _combine(torch.bmm(h, w_out), dest, w)   # (T, D_loc)
    out = comm.reduce(out, (maxis,))               # sum expert groups
    out = comm.gather(out, 1, fsdp)
    return out, _mean_over(r["aux"], region)


def apply_moe(params: Dict, x: torch.Tensor, cfg: MoEConfig,
              mlp: MLPConfig, ctx=None, held_experts: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over x (B, S, D). Returns (out (B, S, D), aux scalar fp32).
    Without a ctx, or with a model dim of width 1, the B·S tokens are
    routed together over every expert; else the expert-parallel paths of
    the module docstring. `held_experts`: the expert stacks arrive as
    this rank's model shard (the training layout) and are used as they
    are; else they arrive whole and are split."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    act = mlp.activation
    w_gate = params.get("w_gate")
    if ctx is None or ctx.mesh is None or ctx.model_shards == 1:
        out, aux = moe_local(params["router"], params["w_in"], w_gate,
                             params["w_out"], xt, cfg=cfg, activation=act)
        return out.view(B, S, D), aux
    if cfg.num_experts % ctx.model_shards != 0:
        raise ValueError(
            f"num_experts={cfg.num_experts} does not split over mesh axis "
            f"{ctx.model_axis!r} ({ctx.model_shards} shards)")
    if cfg.weight_stationary_decode and S == 1 and not held_experts:
        out, aux = _moe_weight_stationary(params, xt, cfg, act, ctx)
        return out.reshape(B, S, D), aux
    maxis = ctx.axis(ctx.model_axis)
    daxes = tuple(ctx.axis(a) for a in ctx.data_axes)
    if (B * S) % comm.flat_width(daxes) != 0:
        # decode at a tiny batch: the tokens ride replicated over data
        daxes = ()
    E_loc = cfg.num_experts // maxis.width

    def experts(w):
        if not held_experts:
            w = comm.split(w, 0, (maxis,))
        return comm.copy(w, daxes)

    x_l = comm.copy(comm.split(xt, 0, daxes), (maxis,))
    out, aux = moe_local(
        comm.copy(params["router"], (maxis,) + daxes), experts(
            params["w_in"]), None if w_gate is None else experts(w_gate),
        experts(params["w_out"]), x_l, cfg=cfg, activation=act,
        e_offset=maxis.coord * E_loc)
    out = comm.gather(comm.reduce(out, (maxis,)), 0, daxes)
    return out.reshape(B, S, D), _mean_over(aux, (maxis,) + daxes)

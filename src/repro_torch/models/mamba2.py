"""Mamba2 (SSD, state-space duality) block of the zamba2 hybrid trunk.

Counterpart of ``repro/models/mamba2.py``. Per head h with head dim P and
state dim N the recurrence is

    h_t = a_t · h_{t-1} + dt_t · (B_t ⊗ x_t)        h ∈ R^{N×P}
    y_t = C_t · h_t + D_skip · x_t

with a scalar decay per head, a_t = exp(-exp(A_log) · dt_t), and
dt_t = softplus(· + dt_bias). Training and prefill run the chunked SSD
algorithm (`apply_mamba2`): exact attention-like sums inside a chunk and a
sequential scan over the chunk states. Every decay factor is the exp of a
difference of cumulative log decays (≤ 0), so the chunked form stays
finite in fp32 at any chunk length. The chunk rule is JAX's: the config's
chunk when it divides S (and S ≥ it), else one chunk of S. `step_mamba2`
serves decode, and `apply_mamba2_scan` runs it token by token as the
oracle of the chunked form. The cast points are JAX's: the projections,
the conv and the gate in the model dtype, the discretisation and the scan
in fp32, the scan's output cast back before the gated norm.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as Fn

from repro_torch.configs.base import SSMConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as shd


def dims(d_model: int, cfg: SSMConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, head dim)."""
    d_inner = cfg.expand * d_model
    P_ = cfg.head_dim
    H = cfg.num_heads or d_inner // P_
    assert H * P_ == d_inner
    return d_inner, H, P_


def mamba2_spec(d_model: int, cfg: SSMConfig, dtype: torch.dtype
                ) -> T.Spec:
    """One block's {key: (shape, init kind, dtype)}, the leaves of JAX's
    ``init_mamba2`` with its inits: in_proj -> [z | x | B | C | dt] and
    out_proj fan-in scaled, conv_w N(0, 0.1), conv_b 0, and in fp32 A_log
    0, D_skip 1 and dt_bias -1."""
    d_inner, H, _ = dims(d_model, cfg)
    N = cfg.state_dim
    conv_ch = d_inner + 2 * N
    f32 = torch.float32
    return {
        "w_in": ((d_model, 2 * d_inner + 2 * N + H), T._DENSE, dtype),
        "conv_w": ((cfg.conv_width, conv_ch), T._NORMAL_TENTH, dtype),
        "conv_b": ((conv_ch,), T._ZEROS, dtype),
        "A_log": ((H,), T._ZEROS, f32),
        "D_skip": ((H,), T._ONES, f32),
        "dt_bias": ((H,), T._NEG_ONES, f32),
        "norm/scale": ((d_inner,), T._ONES, dtype),
        "w_out": ((d_inner, d_model), T._DENSE, dtype),
    }


class Shard(NamedTuple):
    """A block's view of its heads: the whole block (`heads` None), or
    this rank's heads [lo, hi) under tensor parallelism `tp` (the model
    dim's Axis, parallel/sharding.tensor_axis). `d_inner` and `H` count
    the heads it runs; `conv` are its channels of the conv input
    [x | B | C]: its x channels and all of B and C."""

    tp: Any
    heads: Optional[Tuple[int, int]]
    d_inner: int
    H: int
    conv: Tuple[range, ...]


def shard(d_model: int, cfg: SSMConfig, tp=None) -> Shard:
    """The heads a block runs: all of them without `tp`, else this rank's
    (parallel/sharding.head_range), which the model width must divide."""
    d_inner, H, P_ = dims(d_model, cfg)
    N = cfg.state_dim
    heads = shd.head_range(H, tp)
    if tp is None:
        return Shard(None, None, d_inner, H, (range(d_inner + 2 * N),))
    if heads is None:
        raise ValueError(f"the model width {tp.width} does not divide the "
                         f"{H} Mamba2 heads (the gathered route runs "
                         "without tp)")
    lo, hi = heads
    return Shard(tp, heads, (hi - lo) * P_, hi - lo,
                 (range(lo * P_, hi * P_), range(d_inner, d_inner + 2 * N)))


def _local(params: Dict, sh: Shard, cfg: SSMConfig) -> Dict:
    """`params` with the replicated leaves that carry a channel or head dim
    narrowed to the heads of `sh` (no collective; each enters through
    ``comm.copy``, so its gradient sums over the model dim, whose ranks
    read different parts of it): conv_w and conv_b to the shard's conv
    channels, A_log, D_skip and dt_bias to its heads, the norm's scale to
    its x channels. As is without tensor parallelism."""
    if sh.heads is None:
        return params
    lo, hi = sh.heads
    P_ = cfg.head_dim
    tp = (sh.tp,)
    out = dict(params)
    for key in ("conv_w", "conv_b"):
        out[key] = shd.take_columns(comm.copy(params[key], tp), sh.conv)
    for key in ("A_log", "D_skip", "dt_bias"):
        out[key] = comm.copy(params[key], tp)[lo:hi]
    out["norm"] = {"scale": comm.copy(params["norm"]["scale"],
                                      tp)[lo * P_:hi * P_]}
    return out


def _split_proj(params: Dict, x: torch.Tensor, cfg: SSMConfig,
                d_model: int, sh: Shard):
    """(z, x, B, C, dt) of the input projection: the shard's heads' z, x
    and dt and all of B and C (under tensor parallelism
    sharding.column_matmul on this rank's columns of ``w_in``)."""
    d_inner, _, P_ = dims(d_model, cfg)
    N = cfg.state_dim
    if sh.heads is None:
        proj = x @ params["w_in"]
    else:
        cols = shd.mamba_in_columns(d_inner, N, P_, sh.heads)
        proj = shd.column_matmul(x, params["w_in"], sh.tp,
                                 list(cols.values()))
    return torch.split(proj, [sh.d_inner, sh.d_inner, N, N, sh.H], dim=-1)


def _gated_norm(params: Dict, y: torch.Tensor, z: torch.Tensor,
                d_inner: int, sh: Shard) -> torch.Tensor:
    """RMSNorm of y · silu(z) over the whole d_inner. Under tensor
    parallelism each rank holds its heads' channels: the sum of squares
    of its (tokens, 1) partial is summed over the model dim
    (``comm.psum``: each rank then normalises different channels, so the
    gradient sums too)."""
    g = y * Fn.silu(z)
    if sh.heads is None:
        return L.rms_norm(params["norm"], g)
    g32 = g.to(torch.float32)
    ss = comm.psum((g32 * g32).sum(-1, keepdim=True), (sh.tp,))
    out = g32 * torch.rsqrt(ss / d_inner + 1e-6)
    return (out * params["norm"]["scale"].to(torch.float32)).to(g.dtype)


def _whole_conv_input(xr: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                      sh: Shard) -> torch.Tensor:
    """The whole conv input [x | B | C] of the raw projections (the conv
    state keeps every channel, as JAX's cache spec): the shard's x
    channels gathered over the model dim in head order."""
    if sh.heads is not None:
        xr = comm.gather(xr, xr.ndim - 1, (sh.tp,))
    return torch.cat([xr, Bm, Cm], dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv along S, then SiLU. xBC: (B, S, C); w: (W, C).
    `state` (B, W-1, C), where given, is the left context (else zeros),
    in xBC's dtype. JAX pads with min(S, W-1) zeros and so fails on S <
    W-1; this pads W-1 and takes any S."""
    W = w.shape[0]
    if state is None:
        pad = xBC.new_zeros((xBC.shape[0], W - 1, xBC.shape[2]))
    else:
        pad = state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)
    S = xBC.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(W))
    return Fn.silu(out + b)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as jax.nn.softplus computes it (logaddexp, no
    threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _discretize(params: Dict, dt: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dt, log a) in fp32: dt = softplus(dt + dt_bias), log a =
    -exp(A_log)·dt ≤ 0."""
    dt = _softplus(dt.to(torch.float32) + params["dt_bias"])
    return dt, -torch.exp(params["A_log"]) * dt


def apply_mamba2(params: Dict, x: torch.Tensor, cfg: SSMConfig,
                 return_state: bool = False, tp=None):
    """Training / prefill forward, chunked SSD. x: (B, S, D) -> (B, S, D).

    With return_state=True also returns the recurrent state after the last
    token, {ssm (B, H, N, P) fp32, conv (B, W-1, C) the last W-1 raw conv
    inputs, zero-padded on the left when S < W-1}: the chunk scan's last
    state, so prefill hands decode its state without a replay.

    `tp` (the model dim's Axis) runs the block on this rank's heads
    (`shard`), as layers.apply_mlp runs the MLP: ``w_in`` through
    sharding.column_matmul, the conv, the discretisation and the scan on
    its channels and heads, the gated norm's sum of squares summed over
    the model dim, ``w_out`` row-parallel on its shard (head-major rows,
    so they line up) and the partial outputs summed (``comm.reduce``).
    The returned ssm state is then this rank's heads (B, H/tp, N, P) and
    the conv state whole."""
    Bsz, S, D = x.shape
    sh = shard(D, cfg, tp)
    params = _local(params, sh, cfg)
    d_inner, _, P_ = dims(D, cfg)
    dl, H = sh.d_inner, sh.H
    N = cfg.state_dim
    Lc = cfg.chunk_size if (S % cfg.chunk_size == 0
                            and S >= cfg.chunk_size) else S
    nc = S // Lc
    f32 = torch.float32

    z, xr, Bm, Cm, dt = _split_proj(params, x, cfg, D, sh)
    xBC_raw = torch.cat([xr, Bm, Cm], dim=-1)
    xBC = _causal_conv(xBC_raw, params["conv_w"], params["conv_b"])
    xc, Bc, Cc = torch.split(xBC, [dl, N, N], dim=-1)
    dt, log_a = _discretize(params, dt)                   # (B, S, H) fp32

    xh = xc.reshape(Bsz, nc, Lc, H, P_).to(f32)
    Bc = Bc.reshape(Bsz, nc, Lc, N).to(f32)
    Cc = Cc.reshape(Bsz, nc, Lc, N).to(f32)
    dtc = dt.reshape(Bsz, nc, Lc, H)
    cum = torch.cumsum(log_a.reshape(Bsz, nc, Lc, H), dim=2)  # inclusive

    # intra-chunk: y[t] += Σ_{s≤t} C_t·B_s · exp(cum[t] - cum[s]) · dt_s x_s
    G = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B, nc, t, s, H)
    keep = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril_()
    dec = torch.where(keep[None, None, :, :, None], dec,
                      torch.full_like(dec, float("-inf")))
    W = G[..., None] * torch.exp(dec) * dtc[:, :, None, :, :]
    y = torch.einsum("bctsh,bcshp->bcthp", W, xh)

    # chunk states: S_c = Σ_s exp(cum[end] - cum[s]) dt_s B_s ⊗ x_s
    contrib = torch.exp(cum[:, :, -1:, :] - cum) * dtc     # (B, nc, Lc, H)
    S_c = torch.einsum("bcsn,bcshp->bchnp", Bc, contrib[..., None] * xh)
    a_chunk = torch.exp(cum[:, :, -1, :])                  # (B, nc, H)

    h = x.new_zeros((Bsz, H, N, P_), dtype=f32)
    h_prev = []                                            # state BEFORE chunk
    for c in range(nc):
        h_prev.append(h)
        h = h * a_chunk[:, c, :, None, None] + S_c[:, c]
    h_prev = torch.stack(h_prev, dim=1)                    # (B, nc, H, N, P)

    # inter-chunk: y[t] += exp(cum[t]) · C_t · h_prev
    y = y + torch.einsum("bctn,bchnp->bcthp", Cc, h_prev) \
        * torch.exp(cum)[..., None]
    y = y + params["D_skip"][None, None, None, :, None] * xh
    y = y.reshape(Bsz, S, dl).to(x.dtype)
    y = _gated_norm(params, y, z, d_inner, sh)
    out = comm.reduce(y @ params["w_out"], (sh.tp,))
    if return_state:
        Wc = params["conv_w"].shape[0]
        lo = max(S - (Wc - 1), 0)
        tail = _whole_conv_input(xr[:, lo:], Bm[:, lo:], Cm[:, lo:], sh)
        if tail.shape[1] < Wc - 1:                         # S < conv context
            tail = Fn.pad(tail, (0, 0, Wc - 1 - tail.shape[1], 0))
        return out, {"ssm": h, "conv": tail}
    return out


# ---------------------------------------------------------------------------
# Recurrent reference / decode
# ---------------------------------------------------------------------------


def init_mamba2_state(batch: int, d_model: int, cfg: SSMConfig,
                      dtype=torch.float32, *, device: torch.device,
                      tp=None) -> Dict[str, torch.Tensor]:
    """A zero state: the ssm state of the heads `shard` gives under `tp`
    (this rank's, JAX's cache spec by heads), the conv state whole."""
    d_inner, _, P_ = dims(d_model, cfg)
    N = cfg.state_dim
    return {
        "ssm": torch.zeros((batch, shard(d_model, cfg, tp).H, N, P_),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, d_inner + 2 * N),
                            dtype=dtype, device=device),
    }


def step_mamba2(params: Dict, x_t: torch.Tensor, state: Dict,
                cfg: SSMConfig, tp=None) -> Tuple[torch.Tensor, Dict]:
    """One-token step. x_t: (B, 1, D). Returns (out (B, 1, D), the new
    state {ssm fp32, conv in the promoted dtype of the state and x_t}).
    With `tp` as apply_mamba2: the ssm state is this rank's heads, the
    conv state whole (the step convolves its own channels of it and
    appends the whole new conv input)."""
    Bsz, _, D = x_t.shape
    sh = shard(D, cfg, tp)
    params = _local(params, sh, cfg)
    d_inner, _, P_ = dims(D, cfg)
    dl, H = sh.d_inner, sh.H
    N = cfg.state_dim
    f32 = torch.float32
    z, xr, Bm, Cm, dt = _split_proj(params, x_t, cfg, D, sh)
    xBC = torch.cat([xr, Bm, Cm], dim=-1)                  # (B, 1, C_loc)
    conv_in = torch.cat([shd.take_columns(state["conv"], sh.conv), xBC],
                        dim=1)
    out = sum(conv_in[:, i:i + 1] * params["conv_w"][i]
              for i in range(cfg.conv_width))
    xBC_c = Fn.silu(out + params["conv_b"])
    xc, Bv, Cv = torch.split(xBC_c, [dl, N, N], dim=-1)
    dt, log_a = _discretize(params, dt)                    # (B, 1, H)

    xh = xc.reshape(Bsz, H, P_).to(f32)
    Bv = Bv.reshape(Bsz, N).to(f32)
    Cv = Cv.reshape(Bsz, N).to(f32)
    a = torch.exp(log_a)[:, 0, :]                          # (B, H)
    dtv = dt[:, 0, :]
    h = state["ssm"] * a[..., None, None] + \
        (dtv[:, :, None, None] * Bv[:, None, :, None]) * xh[:, :, None, :]
    y = torch.einsum("bn,bhnp->bhp", Cv, h) + \
        params["D_skip"][None, :, None] * xh
    y = y.reshape(Bsz, 1, dl).to(x_t.dtype)
    y = _gated_norm(params, y, z, d_inner, sh)
    conv = torch.cat([state["conv"], _whole_conv_input(xr, Bm, Cm, sh)],
                     dim=1)
    return comm.reduce(y @ params["w_out"], (sh.tp,)), \
        {"ssm": h, "conv": conv[:, 1:]}


def apply_mamba2_scan(params: Dict, x: torch.Tensor,
                      cfg: SSMConfig, tp=None) -> torch.Tensor:
    """Step-by-step reference (the oracle of the chunked form)."""
    Bsz, S, D = x.shape
    state = init_mamba2_state(Bsz, D, cfg, x.dtype, device=x.device, tp=tp)
    ys = []
    for t in range(S):
        y, state = step_mamba2(params, x[:, t:t + 1], state, cfg, tp)
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1)

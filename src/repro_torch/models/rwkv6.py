"""RWKV6 "Finch" block (data-dependent decay linear attention), attention
free.

Counterpart of ``repro/models/rwkv6.py``. Per head (head dim P), with a
per-channel data-dependent decay w_t ∈ (0, 1):

    y_t = r_t · ( S_{t-1} + diag(u) · k_t ⊗ v_t )
    S_t = diag(w_t) · S_{t-1} + k_t ⊗ v_t              S ∈ R^{P×P}

Token-shift "ddlerp" mixing and the decay follow the Finch low-rank
parameterisation; the log decay is clamped to [-2, -1e-6] a step, at
training and decode time alike, as in JAX.

`time_mix` computes the recurrence that JAX's stepwise `step_time_mix`
defines, in chunks: exact sums inside a chunk, factored as
exp(cum_prev[t]) · exp(-cum[s]), and a sequential scan over the chunk
states. Where it differs from JAX's chunked form, on purpose: those
factors are finite only while a chunk spans at most ~44 steps (the clamp
lets |cum| grow by 2 a step, and fp32 overflows near e^88.7). JAX's
chunk is the config's (128 for rwkv6-1.6b), and a length the chunk does
not divide runs as ONE chunk of the whole sequence; there JAX's output is
not finite (on the CPU, head dim 64, D = 128, S = 256, seed 0: at chunk
128, 78 of 256 rows non-finite and the finite ones up to 0.79 off the
stepwise form; at the SMOKE chunk 16, S = 90 and 100 are non-finite).
This module caps the chunk at MAX_CHUNK = 32 steps (|cum| ≤ 64, e^64 ≈
6e27) and runs a length the chunk does not divide as whole chunks plus
one shorter tail chunk. Chunking is exact algebra, so this changes only
rounding; at the SMOKE chunk and a length it divides the algorithm is
JAX's as is.

`time_mix` runs an fp32 model's time mix in fp64 (WKV_DTYPE: its
input, weights, projections, decay, WKV and group norm, cast back to
fp32 at its output), where JAX runs fp32. The loss gradient through the
exp(±cum) factors is ill-conditioned: k·exp(-cum) grows to ~e^32 inside
a chunk while its products with r·exp(cum_prev) stay bounded, so the
gradients of `cum` at each position are large, of opposite signs, and
cancel in the reverse cumsum; a rounding of the factors, or of the r, k,
v and decay they are made from, is magnified there. In fp32 the port's
gradients at width 96 (head dim 16) erred by 1.0e-4 of a leaf's largest
entry against an fp64 run of the same code, JAX's by 1.5e-5; with the
mix in fp64 the port's err by 7.8e-6 (on the CPU,
scripts/rwkv_precision.py; tests/test_torch_rwkv_precision.py holds it).
A bf16 model keeps its WKV in fp32: its inputs are no finer than bf16,
and an fp64 WKV made its training step 1.45x as long (rwkv6-1.6b, 2 ×
4096, on an H100 80GB HBM3 at 700 W; scripts/rwkv_step_ab.py). The
state returned is fp32 either way; the decode step is unchanged.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as Fn

from repro_torch.configs.base import RWKVConfig
from repro_torch.models import transformer as T
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as shd

TM_DIM = 32          # ddlerp low-rank dim
TD_DIM = 64          # decay low-rank dim
LOG_W_MIN = -2.0
LOG_W_MAX = -1e-6
MAX_CHUNK = 32       # steps a chunk spans at most: |cum| ≤ 2·32 = 64
# the time mix's working dtype by the model's: an fp32 model's whole mix
# in fp64, a bf16 model's WKV in fp32 (see the module docstring)
WKV_DTYPE = {torch.bfloat16: torch.float32, torch.float32: torch.float64,
             torch.float64: torch.float64}


def rwkv6_spec(d_model: int, d_ff: int, dtype: torch.dtype) -> T.Spec:
    """One block's {key: (shape, init kind, dtype)}, the leaves of JAX's
    ``init_rwkv6`` with its inits: the token-shift mixes 0, the low-rank
    mixing and decay weights dense_init(scale=1e-2), decay_base 0 and
    bonus_u N(0, 0.1) in fp32, the projections fan-in scaled, the group
    norm's scale 1 and bias 0."""
    D, f32 = d_model, torch.float32
    dense = lambda *s: (s, T._DENSE, dtype)           # noqa: E731
    small = lambda *s: (s, T._DENSE_SMALL, dtype)     # noqa: E731
    zeros = lambda *s: (s, T._ZEROS, dtype)           # noqa: E731
    return {
        "maa_x": zeros(D), "maa": zeros(5, D),
        "tm_w1": small(D, 5 * TM_DIM), "tm_w2": small(5, TM_DIM, D),
        "td_w1": small(D, TD_DIM), "td_w2": small(TD_DIM, D),
        "decay_base": ((D,), T._ZEROS, f32),
        "bonus_u": ((D,), T._NORMAL_TENTH, f32),
        "w_r": dense(D, D), "w_k": dense(D, D), "w_v": dense(D, D),
        "w_g": dense(D, D), "w_o": dense(D, D),
        "ln_x/scale": ((D,), T._ONES, dtype), "ln_x/bias": zeros(D),
        "cm_maa_k": zeros(D), "cm_maa_r": zeros(D),
        "cm_w_k": dense(D, d_ff), "cm_w_v": dense(d_ff, D),
        "cm_w_r": dense(D, D),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1}, with `prev` (B, D) as the t = 0 left context
    (the dtypes promote, as JAX's concatenate does)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _ddlerp(params: Dict, x: torch.Tensor, xx: torch.Tensor):
    """Data-dependent lerp: the 5 mixed inputs [xw, xk, xv, xr, xg]."""
    B, S, D = x.shape
    dx = xx - x
    base = x + dx * params["maa_x"]
    k5 = torch.tanh(base @ params["tm_w1"]).reshape(B, S, 5, TM_DIM)
    deltas = torch.einsum("bsnt,ntd->nbsd", k5, params["tm_w2"])
    return [x + dx * (params["maa"][i] + deltas[i]) for i in range(5)]


def _log_decay(params: Dict, xw: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The clamped log decay (B, S, D) in `dtype` (fp32, or WKV_DTYPE in
    time_mix), the low-rank map in xw's dtype."""
    ww = params["decay_base"].to(dtype) + (torch.tanh(xw @ params["td_w1"])
                                           @ params["td_w2"]).to(dtype)
    return torch.clamp(-torch.exp(ww), LOG_W_MIN, LOG_W_MAX)


def _group_norm(p: Dict, y: torch.Tensor, H: int) -> torch.Tensor:
    """Per-head layer norm in fp32 (fp64 for an fp64 y); y: (B, S, H, P)
    -> (B, S, D) in that dtype."""
    B, S, _, P_ = y.shape
    dt = torch.promote_types(y.dtype, torch.float32)
    y32 = y.to(dt)
    mu = y32.mean(-1, keepdim=True)
    var = y32.var(-1, unbiased=False, keepdim=True)
    yn = ((y32 - mu) * torch.rsqrt(var + 1e-5)).reshape(B, S, H * P_)
    return yn * p["scale"].to(dt) + p["bias"].to(dt)


# the time mix's replicated leaves that every rank reads whole under
# tensor parallelism (see _local)
_WHOLE = ("maa_x", "maa", "tm_w1", "tm_w2", "td_w1")


def heads(d_model: int, cfg: RWKVConfig, tp=None
          ) -> Tuple[int, Optional[Tuple[int, int]]]:
    """(the number of heads a block runs, their range): all of them
    without `tp`, else this rank's (parallel/sharding.head_range), which
    the model width must divide."""
    H = d_model // cfg.head_dim
    if tp is None:
        return H, None
    rng = shd.head_range(H, tp)
    if rng is None:
        raise ValueError(f"the model width {tp.width} does not divide the "
                         f"{H} RWKV6 heads (the gathered route runs "
                         "without tp)")
    return rng[1] - rng[0], rng


def _local(params: Dict, cfg: RWKVConfig, rng, tp) -> Dict:
    """The time mix's leaves on this rank's heads `rng` under tensor
    parallelism (as is without): the decay LoRA's output columns, the
    decay base, the bonus and the group norm's scale and bias narrowed to
    its channels with no collective, the token-shift LoRA and the decay
    LoRA's input read whole. Every replicated leaf enters through
    ``comm.copy``: each rank's use of it reaches the loss through its own
    heads alone, so its gradient sums over the model dim."""
    if rng is None:
        return params
    c = slice(rng[0] * cfg.head_dim, rng[1] * cfg.head_dim)
    out = dict(params)
    for key in _WHOLE:
        out[key] = comm.copy(params[key], (tp,))
    out["td_w2"] = comm.copy(params["td_w2"], (tp,))[:, c]
    for key in ("decay_base", "bonus_u"):
        out[key] = comm.copy(params[key], (tp,))[c]
    out["ln_x"] = {k: comm.copy(v, (tp,))[c]
                   for k, v in params["ln_x"].items()}
    return out


def _wkv_chunks(r, k, v, lw, u, h0, Lc: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked WKV over S = nc·Lc tokens. r, k, v, lw: (B, S, H, P)
    in one float dtype, lw the log decay; u: (H, P); h0: (B, H, P, P) the
    state before the first token. Returns (y (B, S, H, P), the state after the last
    token). Lc ≤ MAX_CHUNK keeps every exp(±cum) finite."""
    B, S, H, P_ = r.shape
    nc = S // Lc
    rc, kc, vc, lwc = (a.reshape(B, nc, Lc, H, P_) for a in (r, k, v, lw))
    cum = torch.cumsum(lwc, dim=2)                     # inclusive, ≤ 0
    cum_prev = cum - lwc                               # decay up to t - 1
    cum_end = cum[:, :, -1:]                           # (B, nc, 1, H, P)

    # intra-chunk, strict lower triangle (the bonus takes the diagonal):
    # score[t, s] = Σ_i r_t[i] k_s[i] exp(cum_prev[t, i] - cum[s, i]), s < t
    q_f = rc * torch.exp(cum_prev)
    k_f = kc * torch.exp(-cum)
    sc = torch.einsum("bcthi,bcshi->bchts", q_f, k_f)
    below = torch.ones((Lc, Lc), dtype=torch.bool, device=r.device).tril_(-1)
    sc = torch.where(below, sc, torch.zeros_like(sc))
    y = torch.einsum("bchts,bcshj->bcthj", sc, vc)
    y = y + (rc * u * kc).sum(-1, keepdim=True) * vc   # bonus: the token

    # chunk states and the inter-chunk scan
    S_c = torch.einsum("bcshi,bcshj->bchij", kc * torch.exp(cum_end - cum),
                       vc)                             # (B, nc, H, P, P)
    a_c = torch.exp(cum_end[:, :, 0])                  # (B, nc, H, P)
    h = h0
    h_prev = []                                        # state BEFORE chunk
    for c in range(nc):
        h_prev.append(h)
        h = h * a_c[:, c, :, :, None] + S_c[:, c]      # decays keys axis i
    y = y + torch.einsum("bcthi,bchij->bcthj", q_f,
                         torch.stack(h_prev, dim=1))
    return y.reshape(B, S, H, P_), h


def _widen(params: Dict, dtype: torch.dtype) -> Dict:
    """Every floating leaf of a block's (nested) params in `dtype`."""
    return {k: _widen(v, dtype) if isinstance(v, dict) else
            v.to(dtype) if v.is_floating_point() else v
            for k, v in params.items()}


def time_mix(params: Dict, x: torch.Tensor, cfg: RWKVConfig,
             shift_prev: torch.Tensor, wkv_state: torch.Tensor, tp=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunked parallel WKV. x: (B, S, D); wkv_state (B, H, P, P) the state
    before the first token. Returns (out in x's dtype, new shift x[:, -1],
    new state fp32). Chunks of min(chunk_size, MAX_CHUNK) tokens, the
    remainder as one tail chunk; in WKV_DTYPE[x.dtype], the whole mix for
    an fp32 x, the WKV for a bf16 x (see the module docstring).

    `tp` (the model dim's Axis) runs the mix on this rank's heads, as
    layers.apply_mlp runs the MLP: x enters through ``comm.copy``, the
    token-shift mixing is computed whole, ``w_r``/``w_k``/``w_v``/``w_g``
    are column-parallel on its heads (contiguous, so aligned), the decay,
    bonus, scan and group norm run on its heads (`_local`), and ``w_o`` is
    row-parallel, the partial outputs summed (``comm.reduce``) in x's
    dtype. The state in and out is then this rank's heads (B, H/tp, P,
    P)."""
    B, S, D = x.shape
    P_ = cfg.head_dim
    H, rng = heads(D, cfg, tp)
    params = _local(params, cfg, rng, tp)
    x = comm.copy(x, (tp,))
    f32, wd, xm = torch.float32, WKV_DTYPE[x.dtype], x
    if x.dtype != torch.bfloat16:       # an fp32 model's whole mix in wd
        params, xm = _widen(params, wd), x.to(wd)
    xw, xk, xv, xr, xg = _ddlerp(params, xm, _shift(xm, shift_prev))
    r, k, v = ((a @ params[w]).reshape(B, S, H, P_).to(wd)
               for a, w in ((xr, "w_r"), (xk, "w_k"), (xv, "w_v")))
    g = Fn.silu(xg @ params["w_g"])
    lw = _log_decay(params, xw, wd).reshape(B, S, H, P_)
    u = params["bonus_u"].reshape(H, P_).to(wd)

    Lc = min(cfg.chunk_size, MAX_CHUNK)
    n_full = (S // Lc) * Lc
    h = wkv_state.to(wd)
    ys = []
    for lo, hi, chunk in ((0, n_full, Lc), (n_full, S, S - n_full)):
        if hi > lo:
            y, h = _wkv_chunks(r[:, lo:hi], k[:, lo:hi], v[:, lo:hi],
                               lw[:, lo:hi], u, h, chunk)
            ys.append(y)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y.to(torch.promote_types(xm.dtype, f32))
    out = _group_norm(params["ln_x"], y, H).to(xm.dtype) * g
    return comm.reduce((out @ params["w_o"]).to(x.dtype), (tp,)), \
        x[:, -1], h.to(f32)


def channel_mix(params: Dict, x: torch.Tensor, shift_prev: torch.Tensor,
                tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The channel mix: sigmoid(xr @ cm_w_r) · (relu(xk @ cm_w_k)² @
    cm_w_v). Under tensor parallelism `tp` ``cm_w_k`` is column-parallel
    (xk enters through ``comm.copy``) and ``cm_w_v`` row-parallel, the
    partial outputs summed (``comm.reduce``); the gate multiplies the
    whole-width output, so every rank computes it whole from its column
    shard of ``cm_w_r`` (sharding.column_matmul)."""
    xx = _shift(x, shift_prev)
    dx = xx - x
    xk = x + dx * params["cm_maa_k"]
    xr = x + dx * params["cm_maa_r"]
    kk = torch.square(torch.relu(comm.copy(xk, (tp,)) @ params["cm_w_k"]))
    gate = xr @ params["cm_w_r"] if tp is None else \
        shd.column_matmul(xr, params["cm_w_r"], tp)
    out = torch.sigmoid(gate) * comm.reduce(kk @ params["cm_w_v"], (tp,))
    return out, x[:, -1]


# ---------------------------------------------------------------------------
# Recurrent step (decode and the oracle)
# ---------------------------------------------------------------------------


def init_rwkv6_state(batch: int, d_model: int, cfg: RWKVConfig,
                     dtype=torch.float32, *, device: torch.device,
                     tp=None) -> Dict[str, torch.Tensor]:
    """A zero state: the wkv state of the heads `heads` gives under `tp`
    (this rank's, JAX's cache spec by heads), the shifts whole."""
    P_ = cfg.head_dim
    return {
        "wkv": torch.zeros((batch, heads(d_model, cfg, tp)[0], P_, P_),
                           dtype=torch.float32, device=device),
        "tm_shift": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "cm_shift": torch.zeros((batch, d_model), dtype=dtype, device=device),
    }


def step_time_mix(params: Dict, x_t: torch.Tensor, cfg: RWKVConfig,
                  state: Dict, tp=None) -> Tuple[torch.Tensor, Dict]:
    """x_t: (B, 1, D) -> (out (B, 1, D), {wkv fp32, tm_shift x_t[:, 0]}).
    `tp` as in time_mix: the wkv state is this rank's heads."""
    B, _, D = x_t.shape
    P_ = cfg.head_dim
    H, rng = heads(D, cfg, tp)
    params = _local(params, cfg, rng, tp)
    x_t = comm.copy(x_t, (tp,))
    f32 = torch.float32
    xx = state["tm_shift"][:, None].to(x_t.dtype)
    xw, xk, xv, xr, xg = _ddlerp(params, x_t, xx)
    r = (xr @ params["w_r"]).reshape(B, H, P_).to(f32)
    k = (xk @ params["w_k"]).reshape(B, H, P_).to(f32)
    v = (xv @ params["w_v"]).reshape(B, H, P_).to(f32)
    g = Fn.silu(xg @ params["w_g"])
    w = torch.exp(_log_decay(params, xw).reshape(B, H, P_))
    u = params["bonus_u"].reshape(H, P_)

    S = state["wkv"]
    kv = k[..., :, None] * v[..., None, :]                   # (B, H, P, P)
    y = torch.einsum("bhi,bhij->bhj", r, S + u[None, :, :, None] * kv)
    S_new = S * w[..., None] + kv
    out = _group_norm(params["ln_x"], y.reshape(B, 1, H, P_), H)
    out = out.to(x_t.dtype) * g
    return comm.reduce(out @ params["w_o"], (tp,)), \
        {"wkv": S_new, "tm_shift": x_t[:, 0]}

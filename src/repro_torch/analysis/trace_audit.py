"""Trace-level audits of the port's contracts.

Counterpart of ``repro/analysis/jaxpr_audit.py``. The JAX audit walks the
jaxprs of its entry points; the port has no traced program, so each entry
point here runs once, at a tiny canonical size, under a dispatch-mode
recorder that sees every aten op it executes (the backward included), and
the recorded ops are held to three invariants:

* **TX001 — host-effect-free hot paths** (JAX's JX001). ``decode_scan``
  is the serving hot loop: its one host sync happens at the CHUNK edge,
  in the engine, never inside. An op that talks to the host inside it,
  or anywhere in the chunk-prefill and train traces, is a regression:
  ``lift_fresh`` (a tensor built from host data: a host-to-device copy
  on the card), ``_local_scalar_dense`` (``.item()``, ``bool(t)``,
  ``int(t)``), ``nonzero`` (a data-dependent shape), and a ``_to_copy``
  or ``copy_`` from one device to another. JAX's "no scan equation"
  check becomes: the chunk's outputs stay on the cache's device and the
  recorder saw its ``n_steps`` decode steps (``sample`` takes one argmax
  a step).
* **TX002 — collective bytes match the comm-cost model** (JX002). The
  sequence-parallel bodies of ``core/seq_parallel.py`` run on a fake
  process group of ``_SP["shards"]`` ranks (the plain twins, on the
  CPU), and the
  collectives they issue through ``parallel/comm.py`` (its ``CALLS`` and
  ``BYTES``: output bytes, as JAX's ``collectives()`` counts avals) must
  be exactly two, of the volume ``blockwise_sp_comm_bytes`` /
  ``seq_parallel_comm_bytes`` advertise.
* **TX003 — no dtype widening on the decode hot path** (JX003): no op of
  the decode chunk may output float64 or complex.

On the card (``device="cuda"``) the entries also run under
``torch.cuda.set_sync_debug_mode("error")``: an op that waits for the
device raises, and the audit reports it as TX001. Findings keep
``repro.analysis.astlint.Finding``'s fields, with paths ``trace:<entry>``
and line 0. The expectations are injectable, so the tests prove each
audit fires.

    python -m repro_torch.analysis.trace_audit [--out FILE]

writes the findings and stats as JSON and exits 1 on a finding.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from typing import Callable, Dict, FrozenSet, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

TX_RULES: Dict[str, str] = {
    "TX001": "host-effect op on a traced hot path",
    "TX002": "collective bytes diverge from the comm-cost model",
    "TX003": "dtype widening (f64/complex) on the decode hot path",
}

# aten ops that talk to the host
HOST_EFFECT_OPS = frozenset({"lift_fresh", "lift_fresh_copy",
                             "_local_scalar_dense", "nonzero"})
# ops that copy, flagged when they cross devices
COPY_OPS = frozenset({"_to_copy", "copy_", "copy"})
WIDE_DTYPES: FrozenSet[torch.dtype] = frozenset(
    {torch.float64, torch.complex64, torch.complex128})

# the sync debug mode's error on the card
SYNC_ERROR = "synchronizing CUDA operation"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation; the fields of ``repro.analysis.astlint.Finding``."""

    rule: str
    path: str      # "trace:<entry>"
    line: int      # 0: a traced op has no source line
    msg: str

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.line}"

    def as_dict(self) -> Dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "msg": self.msg, "key": self.key}


@dataclasses.dataclass
class AuditResult:
    """Findings plus the measured-against-model numbers behind them."""

    findings: List[Finding]
    stats: Dict[str, Dict[str, object]]

    @property
    def ok(self) -> bool:
        return not self.findings


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpEvent:
    """One executed aten op: its name, its outputs' dtypes, and whether it
    copied between devices."""

    name: str
    dtypes: Tuple[torch.dtype, ...]
    crosses_devices: bool


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class Recorder(TorchDispatchMode):
    """Records an :class:`OpEvent` for every aten op run under it."""

    def __init__(self):
        super().__init__()
        self.events: List[OpEvent] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        crosses = name in COPY_OPS and len(
            {t.device for t in _tensors((args, kwargs, out))}) > 1
        self.events.append(OpEvent(
            name, tuple(t.dtype for t in _tensors(out)), crosses))
        return out


def record(fn: Callable, *args, **kwargs):
    """(fn's result, the OpEvents of its run)."""
    with Recorder() as rec:
        out = fn(*args, **kwargs)
    return out, rec.events


def host_effect_ops(events: List[OpEvent]) -> List[str]:
    """The ops that talk to the host, in order (a device-crossing copy as
    "<name> across devices")."""
    found = []
    for e in events:
        if e.name in HOST_EFFECT_OPS:
            found.append(e.name)
        elif e.crosses_devices:
            found.append(f"{e.name} across devices")
    return found


def widenings(events: List[OpEvent],
              forbidden: FrozenSet[torch.dtype] = WIDE_DTYPES) -> List[str]:
    """The forbidden dtypes an op output, by name, in order."""
    return [str(dt).replace("torch.", "") for e in events for dt in e.dtypes
            if dt in forbidden]


def _finding(rule: str, entry: str, msg: str) -> Finding:
    return Finding(rule=rule, path=f"trace:{entry}", line=0, msg=msg)


@contextlib.contextmanager
def _sync_errors(device: torch.device) -> Iterator[None]:
    """On a CUDA device, make every op that waits for the device raise."""
    if device.type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _traced(entry: str, device: torch.device, fn: Callable):
    """(result, events, findings) of fn run under the recorder (and, on
    the card, the sync debug mode); a synchronizing op is a TX001
    finding."""
    rec = Recorder()
    try:
        with _sync_errors(device), rec:
            out = fn()
    except RuntimeError as e:
        if SYNC_ERROR not in str(e):
            raise
        return None, rec.events, [_finding(
            "TX001", entry, f"an op waits for the device after "
            f"{rec.events[-1].name if rec.events else 'no op'}: {e}")]
    return out, rec.events, []


# ---------------------------------------------------------------------------
# canonical tiny instances
# ---------------------------------------------------------------------------

# sequence-parallel audit dims: B=1 and float32 so the measured per-rank
# bytes equal the comm model's (batch-free) count at dtype_bytes=4
_SP = dict(B=1, S=32, shards=2, H=4, Hkv=2, Dh=4, c=8, r=2)


def _tiny_cfg():
    from repro_torch.configs.base import (AttentionConfig, LinformerConfig,
                                          ModelConfig)
    attn = AttentionConfig(
        kind="linformer_causal", backend="reference", num_heads=4,
        num_kv_heads=2, head_dim=8,
        linformer=LinformerConfig(block_size=8, block_slots=2))
    return ModelConfig(name="jaxpr-audit", num_layers=2, d_model=32,
                       vocab_size=256, max_seq_len=64, attention=attn,
                       dtype="float32", remat="none")


# the entries' sizes in blocks of the config (the tiny config: P = 16,
# S = 32, max_seq = 64, as JAX's audit)
_ROWS = 2
_PREFILL_BLOCKS, _TRAIN_BLOCKS, _CACHE_BLOCKS = 2, 4, 8


def _setup(cfg, device):
    from repro_torch.models import model as model_lib
    cfg = cfg if cfg is not None else _tiny_cfg()
    dev = torch.device(device)
    params = model_lib.init_params(cfg, seed=0, device=dev)
    return cfg, dev, params


def _dense_cache(cfg, dev):
    from repro_torch.models import model as model_lib
    from repro_torch.models.transformer import torch_dtype
    c = cfg.attention.linformer.block_size
    return model_lib.init_cache(cfg, batch=_ROWS, max_seq=_CACHE_BLOCKS * c,
                                dtype=torch_dtype(cfg.dtype), device=dev)


def _paged_cache(cfg, dev, page_dtype: str):
    from repro_torch.core import cache as cache_lib
    a = cfg.attention
    return cache_lib.init_paged_cache(
        device=dev, num_layers=cfg.num_layers, batch=_ROWS,
        max_seq=_CACHE_BLOCKS * a.linformer.block_size,
        block_size=a.linformer.block_size,
        block_slots=a.linformer.block_slots, num_kv_heads=a.num_kv_heads,
        head_dim=a.head_dim, page_dtype=page_dtype)


# ---------------------------------------------------------------------------
# audits
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _sp_axis() -> Iterator[object]:
    """The "seq" Axis of a fake process group of _SP["shards"] ranks."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.parallel.sharding import ParallelCtx
    with mesh_lib.fake_world(_SP["shards"]):
        mesh = mesh_lib.make_mesh((_SP["shards"],), ("seq",),
                                  device_type="cpu")
        yield ParallelCtx(mesh=mesh).axis("seq")


def _sp_run(body: Callable, shapes: Dict[str, Tuple[int, ...]]):
    """Run `body` on seeded fp32 CPU tensors of `shapes` (this rank's
    shard) under the fake group, which moves no byte (what a collective
    hands back is not read); returns comm's (calls, bytes) by op."""
    from repro_torch.parallel import comm
    rng = np.random.default_rng(0)
    xs = {k: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
          for k, s in shapes.items()}
    with _sp_axis() as axis:
        comm.reset_counters()
        body(axis, **xs)
        return dict(comm.CALLS), dict(comm.BYTES)


def _sp_local_shapes(E_rows: int, K: int) -> Dict[str, Tuple[int, ...]]:
    d, n = _SP, _SP["S"] // _SP["shards"]
    return {"q": (d["B"], n, d["H"], d["Dh"]),
            "k": (d["B"], n, d["Hkv"], d["Dh"]),
            "v": (d["B"], n, d["Hkv"], d["Dh"]),
            "E": (E_rows, K), "F": (E_rows, K)}


def audit_sp_causal(expect_lin: Optional[int] = None,
                    ) -> Tuple[List[Finding], Dict[str, object]]:
    """Run the blockwise-causal sequence-parallel body on the fake group
    and hold its all-gather volume to `blockwise_sp_comm_bytes`.
    `expect_lin` overrides the model's byte count (tests inject a wrong
    value to prove the audit fires)."""
    from repro_torch.core.seq_parallel import (blockwise_sp_comm_bytes,
                                               sp_blockwise_causal_attention)
    d = _SP

    def body(axis, q, k, v, E, F):
        sp_blockwise_causal_attention(
            q, k, v, E, F, seq_axis=axis, block_size=d["c"],
            block_slots=d["r"], scale=d["Dh"] ** -0.5)

    calls, nbytes = _sp_run(body, _sp_local_shapes(d["c"], d["r"]))
    gathers, measured = calls.get("all_gather", 0), nbytes.get(
        "all_gather", 0)
    model, _ = blockwise_sp_comm_bytes(d["S"], d["c"], d["r"],
                                       d["Hkv"] * d["Dh"], d["shards"],
                                       dtype_bytes=4)
    expected = model if expect_lin is None else expect_lin
    findings: List[Finding] = []
    if gathers != 2 or sum(calls.values()) != 2:
        findings.append(_finding(
            "TX002", "sp_causal",
            f"expected exactly 2 all_gathers (compressed k/v prefix), "
            f"issued {calls}"))
    if measured != expected:
        findings.append(_finding(
            "TX002", "sp_causal",
            f"all-gather volume {measured}B != comm model "
            f"blockwise_sp_comm_bytes={expected}B"))
    return findings, {"all_gathers": gathers, "gathered_bytes": measured,
                      "model_bytes": model}


def audit_sp_exact(expect_lin: Optional[int] = None,
                   ) -> Tuple[List[Finding], Dict[str, object]]:
    """Run the exact-form sequence-parallel body on the fake group and
    hold its psum volume to `seq_parallel_comm_bytes`."""
    from repro_torch.core.seq_parallel import (seq_parallel_comm_bytes,
                                               sp_exact_linformer_attention)
    d = _SP
    K = (d["S"] // d["c"]) * d["r"]          # compressed width

    def body(axis, q, k, v, E, F):
        sp_exact_linformer_attention(q, k, v, E, F, seq_axis=axis,
                                     scale=d["Dh"] ** -0.5, fused=False)

    calls, nbytes = _sp_run(body, _sp_local_shapes(d["S"] // d["shards"],
                                                   K))
    psums, measured = calls.get("psum", 0), nbytes.get("psum", 0)
    model, _ = seq_parallel_comm_bytes(d["S"], K, d["Hkv"] * d["Dh"],
                                       d["shards"], dtype_bytes=4)
    expected = model if expect_lin is None else expect_lin
    findings: List[Finding] = []
    if psums != 2 or sum(calls.values()) != 2:
        findings.append(_finding(
            "TX002", "sp_exact",
            f"expected exactly 2 psums (compressed k/v), issued {calls}"))
    if measured != expected:
        findings.append(_finding(
            "TX002", "sp_exact",
            f"psum volume {measured}B != comm model "
            f"seq_parallel_comm_bytes={expected}B"))
    return findings, {"psums": psums, "psum_bytes": measured,
                      "model_bytes": model}


def audit_decode(n_steps: int = 4,
                 forbidden: FrozenSet[torch.dtype] = WIDE_DTYPES, *,
                 cfg=None, device: str = "cpu",
                 page_dtype: Optional[str] = None,
                 ) -> Tuple[List[Finding], Dict[str, object]]:
    """Run `model.decode_scan` (the serving decode chunk) at temperature
    0.7 from a seeded generator and hold it to TX001 and TX003; the cache
    is dense, or the paged pool in `page_dtype` ("int8", "fp8")."""
    from repro_torch.models import model as model_lib
    cfg, dev, params = _setup(cfg, device)
    cache = _dense_cache(cfg, dev) if page_dtype is None \
        else _paged_cache(cfg, dev, page_dtype)
    cur = torch.zeros((_ROWS,), dtype=torch.int32, device=dev)
    fin = torch.zeros((_ROWS,), dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    entry = "decode_scan" if page_dtype is None \
        else f"decode_scan[{page_dtype}]"
    out, events, findings = _traced(entry, dev, lambda: model_lib.decode_scan(
        params, cfg, cur, fin, cache, n_steps=n_steps, eos_id=1,
        temperature=0.7, generator=gen))
    steps = sum(e.name == "argmax" for e in events)
    if out is not None:
        on = {t.device for t in out[:4]}
        if steps != n_steps or on != {cache["lengths"].device}:
            findings.append(_finding(
                "TX001", entry,
                f"the decode chunk ran {steps} of {n_steps} steps on the "
                f"device, its outputs on {sorted(map(str, on))}: it is no "
                "longer one device-resident loop"))
    effects = host_effect_ops(events)
    for op in sorted(set(effects)):
        findings.append(_finding(
            "TX001", entry,
            f"host-effect op '{op}' inside the decode chunk (the chunk "
            f"contract allows one host sync per chunk, at the edge)"))
    wide = widenings(events, forbidden)
    for dt in sorted(set(wide)):
        findings.append(_finding(
            "TX003", entry, f"an op outputs {dt} on the decode hot path"))
    return findings, {"steps": steps, "ops": len(events),
                      "host_effects": len(effects), "widenings": len(wide)}


def audit_prefill(*, cfg=None, device: str = "cpu",
                  ) -> Tuple[List[Finding], Dict[str, object]]:
    """Run the chunked-prefill entry point with `n_valid` a device tensor
    (as JAX passes a device array); it must be host-effect-free (the
    scheduler owns its one sync, after the call)."""
    from repro_torch.models import model as model_lib
    cfg, dev, params = _setup(cfg, device)
    cache = _dense_cache(cfg, dev)
    P = _PREFILL_BLOCKS * cfg.attention.linformer.block_size
    toks = torch.zeros((_ROWS, P), dtype=torch.int32, device=dev)
    n_valid = torch.full((_ROWS,), P, dtype=torch.int32, device=dev)
    _, events, findings = _traced("prefill_chunk", dev, lambda:
                                  model_lib.prefill_chunk(params, cfg, toks,
                                                          cache, n_valid))
    effects = host_effect_ops(events)
    for op in sorted(set(effects)):
        findings.append(_finding(
            "TX001", "prefill_chunk",
            f"host-effect op '{op}' in the chunked-prefill trace"))
    return findings, {"ops": len(events), "host_effects": len(effects)}


def audit_train(*, cfg=None, device: str = "cpu",
                ) -> Tuple[List[Finding], Dict[str, object]]:
    """Run the train step's forward and backward (`loss_fn`, then
    `backward()` into parameters that require grad, autograd Functions
    included); it must be host-effect-free."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.transformer import flatten
    cfg, dev, params = _setup(cfg, device)
    for p in flatten(params).values():
        p.requires_grad_(True)
    S = _TRAIN_BLOCKS * cfg.attention.linformer.block_size
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (_ROWS, S + 1),
                                         dtype=np.int32)).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": torch.ones((_ROWS, S), dtype=torch.float32,
                                     device=dev)}

    def step():
        total, _ = model_lib.loss_fn(params, cfg, batch)
        total.backward()

    _, events, findings = _traced("train_step", dev, step)
    effects = host_effect_ops(events)
    for op in sorted(set(effects)):
        findings.append(_finding(
            "TX001", "train_step",
            f"host-effect op '{op}' in the train forward/backward trace"))
    return findings, {"ops": len(events), "host_effects": len(effects)}


def run_audit() -> AuditResult:
    """Every audit at the tiny canonical size on the CPU."""
    findings: List[Finding] = []
    stats: Dict[str, Dict[str, object]] = {}
    for name, fn in (("sp_causal", audit_sp_causal),
                     ("sp_exact", audit_sp_exact),
                     ("decode_scan", audit_decode),
                     ("prefill_chunk", audit_prefill),
                     ("train_step", audit_train)):
        f, s = fn()
        findings.extend(f)
        stats[name] = s
    return AuditResult(findings=findings, stats=stats)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="write the JSON here (default: stdout)")
    args = ap.parse_args(argv)
    res = run_audit()
    text = json.dumps({"ok": res.ok, "rules": TX_RULES,
                       "findings": [f.as_dict() for f in res.findings],
                       "stats": res.stats}, indent=1) + "\n"
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    else:
        sys.stdout.write(text)
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())

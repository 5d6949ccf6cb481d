"""The persistent tuning table: shape-bucketed kernel/scheduler winners.

Copy of ``repro/tune/table.py`` with the port's own file and platform key.
Schema (``TUNING_TORCH.json`` at the repo root, regenerated by
``python -m repro_torch.tune.autotune``)::

    {"version": 1,
     "generated_by": "repro_torch.tune.autotune", "mode": "smoke"|"full",
     "card": "<nvidia-smi name, power limit>",
     "entries": [
       {"platform": "cuda:NVIDIA H100 80GB HBM3",   # platform_key(device)
        "form": "causal_chunked",           # "exact" | "causal_chunked"
                                            # | "scalars"
        "bucket": {"seq": 8192},            # null for "scalars"
        "params": {"q_chunk_blocks": 4},    # the tuned knob(s)
        "trial_us": 812.4, "default_us": 997.1,
        "speedup": 1.23, "trials": 5}, ...]}

Bucket keys are **next-pow2 on seq/slots, exact on heads/dtype**: a lookup
buckets its query the same way, so any shape inside a pow2 band shares one
entry. An entry may constrain a *subset* of the bucket keys (e.g.
``causal_chunked`` entries bucket on ``seq`` only); the most specific
matching entry wins, ties broken by file order. ``scalars`` entries are
platform-wide (``bucket: null``): ``chunked_min_seq``, ``decode_chunk``,
``prefill_chunk``.

The platform key is the port's: ``"cpu"`` for a CPU device and ``"cuda:" +
torch.cuda.get_device_name(device)`` for a card (the JAX package keys on
``jax.default_backend()``). Every lookup takes the platform of the device
its caller works on. The committed table holds card entries only, so on
the CPU every lookup misses and takes the defaults.

Lookups cost a dict scan per call, never touch a device, and **fall back
to the hand-picked defaults in `kernels/common.py`** on any miss: a
missing, corrupt or wrong-platform table can never change semantics, only
leave performance on the table. Hit/miss counts accumulate in module stats
that the serving engine drains into its telemetry after each serve
(``tuning_table_hit_total`` / ``tuning_table_miss_total``). The port counts
one lookup a call; JAX counts one a trace.

``REPRO_TORCH_TUNING_PATH`` overrides the table location.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
from typing import Dict, List, Optional, Sequence, Union

import torch

from repro_torch.kernels import common as kcommon

TABLE_VERSION = 1
TABLE_BASENAME = "TUNING_TORCH.json"
ENV_PATH = "REPRO_TORCH_TUNING_PATH"

# form -> the knobs an entry of that form may tune. All knobs are pure
# performance parameters: they partition work or pick thresholds, never
# change the math.
TUNABLE_PARAMS: Dict[str, frozenset] = {
    "exact": frozenset({"block_q", "block_s"}),
    "causal_chunked": frozenset({"q_chunk_blocks"}),
    "scalars": frozenset({"chunked_min_seq", "decode_chunk",
                          "prefill_chunk"}),
}
BUCKET_KEYS = ("seq", "slots", "heads", "dtype")

_STATS = {"hits": 0, "misses": 0}


def default_path() -> str:
    """$REPRO_TORCH_TUNING_PATH if set, else <repo root>/TUNING_TORCH.json."""
    env = os.environ.get(ENV_PATH)
    if env:
        return env
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    return os.path.join(root, TABLE_BASENAME)


@functools.lru_cache(maxsize=None)
def _cuda_key(index: int) -> str:
    return "cuda:" + torch.cuda.get_device_name(index)


def platform_key(device: Union[str, torch.device, None] = None) -> str:
    """The table's platform key of `device`: "cpu", or "cuda:<device
    name>" for a card. None means the card when one is available, else
    the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    return _cuda_key(dev.index if dev.index is not None
                     else torch.cuda.current_device())


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (bucket key for seq/slots axes)."""
    if n < 1:
        raise ValueError(f"bucket dimension must be >= 1, got {n}")
    return 1 << (int(n) - 1).bit_length()


def shape_bucket(*, seq: Optional[int] = None, slots: Optional[int] = None,
                 heads: Optional[int] = None,
                 dtype: Optional[str] = None) -> Dict[str, object]:
    """Canonical bucket for a concrete shape: next-pow2 on seq/slots,
    exact on heads/dtype. Only the provided keys appear."""
    bucket: Dict[str, object] = {}
    if seq is not None:
        bucket["seq"] = next_pow2(seq)
    if slots is not None:
        bucket["slots"] = next_pow2(slots)
    if heads is not None:
        bucket["heads"] = int(heads)
    if dtype is not None:
        bucket["dtype"] = str(dtype)
    return bucket


def validate_doc(doc: object) -> List[str]:
    """Schema errors for a parsed table document ([] = valid). Used by
    `TuningTable.load` (silent fallback) and `TuningTable.save`."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return [f"top level must be an object, got {type(doc).__name__}"]
    if doc.get("version") != TABLE_VERSION:
        errs.append(f"version must be {TABLE_VERSION}, "
                    f"got {doc.get('version')!r}")
    entries = doc.get("entries")
    if not isinstance(entries, list):
        return errs + ["'entries' must be a list"]
    for i, e in enumerate(entries):
        where = f"entries[{i}]"
        if not isinstance(e, dict):
            errs.append(f"{where}: must be an object")
            continue
        if not isinstance(e.get("platform"), str) or not e.get("platform"):
            errs.append(f"{where}: 'platform' must be a non-empty string")
        form = e.get("form")
        if form not in TUNABLE_PARAMS:
            errs.append(f"{where}: unknown form {form!r} "
                        f"(one of {sorted(TUNABLE_PARAMS)})")
            continue
        params = e.get("params")
        if not isinstance(params, dict) or not params:
            errs.append(f"{where}: 'params' must be a non-empty object")
        else:
            bad = sorted(set(params) - TUNABLE_PARAMS[form])
            if bad:
                errs.append(f"{where}: params {bad} not tunable for "
                            f"form {form!r}")
            for k, v in params.items():
                if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                    errs.append(f"{where}: params[{k!r}] must be a "
                                f"positive int, got {v!r}")
        bucket = e.get("bucket")
        if form == "scalars":
            if bucket is not None:
                errs.append(f"{where}: scalars entries are platform-wide "
                            "(bucket must be null)")
        elif not isinstance(bucket, dict) or not bucket:
            errs.append(f"{where}: 'bucket' must be a non-empty object")
        else:
            bad = sorted(set(bucket) - set(BUCKET_KEYS))
            if bad:
                errs.append(f"{where}: unknown bucket keys {bad}")
            for k in ("seq", "slots", "heads"):
                v = bucket.get(k)
                if v is not None and (not isinstance(v, int)
                                      or isinstance(v, bool) or v < 1):
                    errs.append(f"{where}: bucket[{k!r}] must be a "
                                f"positive int, got {v!r}")
            for k in ("seq", "slots"):
                v = bucket.get(k)
                if isinstance(v, int) and not isinstance(v, bool) \
                        and v >= 1 and v & (v - 1):
                    errs.append(f"{where}: bucket[{k!r}]={v} is not a "
                                "power of two")
            if "dtype" in bucket and not isinstance(bucket["dtype"], str):
                errs.append(f"{where}: bucket['dtype'] must be a string")
        for k in ("trial_us", "default_us"):
            v = e.get(k)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or v <= 0:
                errs.append(f"{where}: {k!r} must be a positive number, "
                            f"got {v!r}")
        v = e.get("trials")
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            errs.append(f"{where}: 'trials' must be a positive int, "
                        f"got {v!r}")
    return errs


class TuningTable:
    """In-memory view of a table document. Immutable by convention after
    load; the autotuner builds one with `add()` and `save()`s it."""

    def __init__(self, entries: Optional[Sequence[Dict]] = None, *,
                 meta: Optional[Dict] = None):
        self.entries: List[Dict] = list(entries or ())
        self.meta: Dict = dict(meta or {})

    # -- construction / persistence ------------------------------------

    def add(self, *, platform: str, form: str, bucket: Optional[Dict],
            params: Dict[str, int], trial_us: float, default_us: float,
            trials: int) -> None:
        if form not in TUNABLE_PARAMS:
            raise ValueError(f"unknown form {form!r}")
        if set(params) - TUNABLE_PARAMS[form]:
            raise ValueError(f"params {sorted(params)} not tunable for "
                             f"form {form!r}")
        self.entries.append({
            "platform": platform, "form": form, "bucket": bucket,
            "params": dict(params),
            "trial_us": round(float(trial_us), 3),
            "default_us": round(float(default_us), 3),
            "speedup": round(float(default_us) / float(trial_us), 3),
            "trials": int(trials),
        })

    def to_doc(self) -> Dict:
        return {"version": TABLE_VERSION, **self.meta,
                "entries": self.entries}

    def save(self, path: Optional[str] = None) -> str:
        path = path or default_path()
        errs = validate_doc(self.to_doc())
        if errs:
            raise ValueError("refusing to save an invalid tuning table: "
                             + "; ".join(errs))
        with open(path, "w") as fh:
            json.dump(self.to_doc(), fh, indent=2, sort_keys=True)
            fh.write("\n")
        return path

    @classmethod
    def load(cls, path: Optional[str] = None) -> "TuningTable":
        """Load a table; a missing, unreadable or schema-invalid file
        yields an EMPTY table (every lookup falls back to defaults): the
        table is a performance hint, never a correctness dependency."""
        path = path or default_path()
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, json.JSONDecodeError, ValueError):
            return cls()
        if validate_doc(doc):
            return cls()
        meta = {k: v for k, v in doc.items()
                if k not in ("version", "entries")}
        return cls(doc["entries"], meta=meta)

    # -- lookup ---------------------------------------------------------

    def lookup(self, form: str, *, seq: Optional[int] = None,
               slots: Optional[int] = None, heads: Optional[int] = None,
               dtype: Optional[str] = None,
               platform: Optional[str] = None) -> Dict[str, int]:
        """Tuned params for (platform, form, shape bucket), or {} on miss.
        An entry matches when every bucket key it constrains equals the
        query's bucketed value; the most specific match wins (ties: first
        in file order). `platform` None: `platform_key()`."""
        platform = platform if platform is not None else platform_key()
        query = shape_bucket(seq=seq, slots=slots, heads=heads,
                             dtype=dtype)
        best: Optional[Dict] = None
        best_n = -1
        for e in self.entries:
            if e["form"] != form or e["platform"] != platform:
                continue
            bucket = e.get("bucket") or {}
            if any(k not in query or query[k] != v
                   for k, v in bucket.items()):
                continue
            if len(bucket) > best_n:
                best, best_n = e, len(bucket)
        if best is None:
            _STATS["misses"] += 1
            return {}
        _STATS["hits"] += 1
        return dict(best["params"])

    def scalar(self, name: str, default: int, *,
               platform: Optional[str] = None) -> int:
        """Platform-wide tuned scalar (decode_chunk, chunked_min_seq,
        prefill_chunk) with fallback to the caller's default."""
        params = self.lookup("scalars", platform=platform)
        return int(params.get(name, default))


# -- module-level cached table + stats --------------------------------------

_CACHED: Optional[TuningTable] = None
_CACHED_PATH: Optional[str] = None
_OVERRIDE_PATH = "<override>"


def get_table() -> TuningTable:
    """The process-wide table, loaded once per path (the path can change
    through REPRO_TORCH_TUNING_PATH between loads; tests use
    clear_table_cache). An active override() pins the table whatever the
    path."""
    global _CACHED, _CACHED_PATH
    if _CACHED_PATH == _OVERRIDE_PATH:
        return _CACHED
    path = default_path()
    if _CACHED is None or path != _CACHED_PATH:
        _CACHED = TuningTable.load(path)
        _CACHED_PATH = path
    return _CACHED


def clear_table_cache() -> None:
    global _CACHED, _CACHED_PATH
    _CACHED = None
    _CACHED_PATH = None


@contextlib.contextmanager
def override(table: Optional[TuningTable]):
    """Temporarily install `table` (None = empty) as the process table:
    defaults-against-tuned legs and tests switch tables in-process with
    this."""
    global _CACHED, _CACHED_PATH
    prev, prev_path = _CACHED, _CACHED_PATH
    _CACHED = table if table is not None else TuningTable()
    _CACHED_PATH = _OVERRIDE_PATH
    try:
        yield
    finally:
        _CACHED, _CACHED_PATH = prev, prev_path


def consume_stats() -> Dict[str, int]:
    """Return and reset the lookup hit/miss counters (the serving engine
    drains these into its metrics registry after each serve)."""
    out = dict(_STATS)
    _STATS["hits"] = 0
    _STATS["misses"] = 0
    return out


# -- typed lookup helpers (the call sites the stack uses) --------------------


def block_q_for(*, seq: int, slots: int, heads: int, dtype,
                platform: Optional[str] = None) -> int:
    """Tuned query tile of the exact form, kept for schema parity with the
    JAX package: no call site of the port reads it, because kernels 5 and
    6 fix their tiles at compile time (kernels/common.py)."""
    p = get_table().lookup("exact", seq=seq, slots=slots, heads=heads,
                           dtype=str(dtype), platform=platform)
    return int(p.get("block_q", kcommon.DEFAULT_BLOCK_Q))


def block_s_for(*, seq: int, slots: int, heads: int, dtype,
                platform: Optional[str] = None) -> int:
    """Tuned sequence tile of the exact form's projection; schema parity
    only, as :func:`block_q_for`."""
    p = get_table().lookup("exact", seq=seq, slots=slots, heads=heads,
                           dtype=str(dtype), platform=platform)
    return int(p.get("block_s", kcommon.DEFAULT_BLOCK_S))


def q_chunk_blocks_for(*, seq: int, platform: Optional[str] = None) -> int:
    """Tuned query-chunk width (in blocks) of the chunked reference form
    (`core.causal.blockwise_causal_attention_chunked`)."""
    p = get_table().lookup("causal_chunked", seq=seq, platform=platform)
    return int(p.get("q_chunk_blocks", kcommon.DEFAULT_Q_CHUNK_BLOCKS))


def scalar(name: str, default: int, *,
           platform: Optional[str] = None) -> int:
    """Platform-wide tuned scalar with the caller's fallback default."""
    return get_table().scalar(name, default, platform=platform)

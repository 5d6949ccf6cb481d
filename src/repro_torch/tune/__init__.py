"""Benchmark-driven tuning of the port's scheduler scalars and reference
forms.

Counterpart of ``repro/tune``. `table.py` is the runtime side: the
persistent ``TUNING_TORCH.json`` table (shape-bucketed winners per platform
key and form) read by the chunked reference form and its threshold
(`core/causal.py`) and by the serving engine's decode-chunk default, with a
fallback to the hand-picked defaults on any miss. `autotune.py` is the
offline side: the sweep that times the real entry points on a device and
regenerates the table (``python -m repro_torch.tune.autotune``).
"""
from repro_torch.tune.table import (TuningTable, clear_table_cache,  # noqa: F401
                                    consume_stats, get_table, next_pow2,
                                    override, platform_key, shape_bucket,
                                    validate_doc)

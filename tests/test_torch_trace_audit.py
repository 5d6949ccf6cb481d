"""The port's trace audit (repro_torch/analysis/trace_audit.py) against the
JAX package's jaxpr audit: a counterpart of each case of
tests/test_static_analysis.py's TestJaxprAudit, a `.item()` placed inside
the decode loop, and the sequence-parallel byte counts held to the JAX
package's comm model (the one JAX's audit holds its traced bytes to) at
the same `_SP` dims."""
import json

import jax  # noqa: F401  (JAX on the CPU, as the JAX package's tests run)
import pytest
import torch

from repro.analysis import jaxpr_audit as JA
from repro.core.seq_parallel import (blockwise_sp_comm_bytes,
                                     seq_parallel_comm_bytes)
from repro_torch.analysis import trace_audit as TA
from repro_torch.models import model as model_lib


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sp_causal_matches_comm_model():
    findings, stats = TA.audit_sp_causal()
    assert findings == []
    assert stats["all_gathers"] == 2
    assert stats["gathered_bytes"] == stats["model_bytes"]


def test_sp_causal_fires_on_injected_expectation():
    findings, _ = TA.audit_sp_causal(expect_lin=1)
    assert [f.rule for f in findings] == ["TX002"]
    assert findings[0].path == "trace:sp_causal"
    assert findings[0].line == 0


def test_sp_exact_matches_comm_model():
    findings, stats = TA.audit_sp_exact()
    assert findings == []
    assert stats["psums"] == 2
    assert stats["psum_bytes"] == stats["model_bytes"]


def test_sp_exact_fires_on_injected_expectation():
    findings, _ = TA.audit_sp_exact(expect_lin=1)
    assert [f.rule for f in findings] == ["TX002"]
    assert findings[0].path == "trace:sp_exact"


def _jax_sp_model(name):
    """JAX's comm model at JAX's `_SP`, fp32, as `jaxpr_audit.audit_sp_*`
    computes the volume it holds its traced collectives to (JX002):
    (collectives, bytes, the stat that measures them)."""
    d = JA._SP
    if name == "sp_causal":
        model, _ = blockwise_sp_comm_bytes(d["S"], d["c"], d["r"],
                                           d["Hkv"] * d["Dh"], d["shards"],
                                           dtype_bytes=4)
        return 2, model, ("all_gathers", "gathered_bytes")
    K = (d["S"] // d["c"]) * d["r"]
    model, _ = seq_parallel_comm_bytes(d["S"], K, d["Hkv"] * d["Dh"],
                                       d["shards"], dtype_bytes=4)
    return 2, model, ("psums", "psum_bytes")


@pytest.mark.parametrize("name", ["sp_causal", "sp_exact"])
def test_sp_bytes_equal_jax_audit_stats(name):
    """The port's measured collective count and bytes equal JAX's audit's
    expectation at the same `_SP` dims: two collectives moving the volume
    of the JAX package's own comm model."""
    assert TA._SP == JA._SP
    findings, mine = getattr(TA, f"audit_{name}")()
    calls, model, (n_key, bytes_key) = _jax_sp_model(name)
    assert findings == []
    assert (mine[n_key], mine[bytes_key]) == (calls, model)
    assert mine["model_bytes"] == model


def test_decode_chunk_is_host_effect_free():
    findings, stats = TA.audit_decode()
    assert findings == []
    assert stats["steps"] == 4
    assert stats["host_effects"] == 0
    assert stats["widenings"] == 0


def test_host_effect_detection_fires_on_item_in_a_loop():
    def noisy(x):
        for _ in range(3):
            x = x + 1
            x.sum().item()
        return x

    _, events = TA.record(noisy, torch.zeros(3))
    assert TA.host_effect_ops(events) == ["_local_scalar_dense"] * 3
    _, events = TA.record(lambda: torch.tensor([1.0, 2.0]) * 2)
    assert TA.host_effect_ops(events) == ["lift_fresh"]


def test_item_inside_the_decode_loop_fires_tx001(monkeypatch):
    """A `.item()` placed in the decode loop's sampling step is caught, and
    nothing else is."""
    sample = model_lib.sample

    def syncing_sample(logits, temperature=0.0, generator=None):
        logits.sum().item()
        return sample(logits, temperature, generator)

    monkeypatch.setattr(model_lib, "sample", syncing_sample)
    findings, stats = TA.audit_decode()
    assert [(f.rule, f.path) for f in findings] == \
        [("TX001", "trace:decode_scan")]
    assert "_local_scalar_dense" in findings[0].msg
    assert stats["host_effects"] == 4


def test_widening_detection():
    _, events = TA.record(lambda x: x.to(torch.float16),
                          torch.zeros(3, dtype=torch.float32))
    assert TA.widenings(events, frozenset({torch.float16})) == ["float16"]
    assert TA.widenings(events) == []     # f16 is not a forbidden widen
    _, events = TA.record(lambda x: x.double(), torch.zeros(3))
    assert TA.widenings(events) == ["float64"]


def test_widening_in_the_decode_loop_fires_tx003(monkeypatch):
    sample = model_lib.sample

    def widening_sample(logits, temperature=0.0, generator=None):
        return sample(logits.double(), temperature, generator)

    monkeypatch.setattr(model_lib, "sample", widening_sample)
    findings, _ = TA.audit_decode()
    assert [(f.rule, f.path) for f in findings] == \
        [("TX003", "trace:decode_scan")]


def test_prefill_and_train_traces_clean():
    for fn in (TA.audit_prefill, TA.audit_train):
        findings, stats = fn()
        assert findings == []
        assert stats["host_effects"] == 0
        assert stats["ops"] > 0


def test_paged_decode_chunk_is_host_effect_free():
    findings, stats = TA.audit_decode(page_dtype="int8")
    assert findings == []
    assert stats["steps"] == 4


def test_main_writes_findings_and_exit_code(tmp_path, monkeypatch):
    out = tmp_path / "audit.json"
    assert TA.main(["--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["ok"] is True and doc["findings"] == []
    assert set(doc["stats"]) == {"sp_causal", "sp_exact", "decode_scan",
                                 "prefill_chunk", "train_step"}
    exact = TA.audit_sp_exact
    monkeypatch.setattr(TA, "audit_sp_exact", lambda: exact(expect_lin=1))
    assert TA.main(["--out", str(out)]) == 1
    assert [f["rule"] for f in json.loads(out.read_text())["findings"]] == \
        ["TX002"]

"""Unit tests for bench.py's record assembly, gating, and emit machinery.
Pure CPU: no jax, no card; exercises _Record/_Phases directly."""

from __future__ import annotations

import importlib.util
import io
import json
import os
import sys
from contextlib import redirect_stdout


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(__file__), "..", "bench.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _emit(rec) -> dict:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rec.emit()
    return json.loads(buf.getvalue().strip())


def test_record_emits_parseable_json_when_empty():
    bench = _load_bench()
    out = _emit(bench._Record())
    assert out["value"] == 0.0
    assert out["best_gated_turbo_4k_mpix_s"] == 0.0
    assert out["unit"] == "Mpix/s" and "metric" in out


def test_geomean_uses_only_gated_rows():
    """value is the exact-kernel geomean; the best-gated fields take only
    gate-passing rows, while ungated rows are still published."""
    bench = _load_bench()
    rec = bench._Record()
    rec.out["bilateral_4k_mpix_s"] = 400.0
    rec.out["nlm_4k_mpix_s"] = 100.0
    d4k5, d8s6 = (4, 5, None), (8, 6, 6.0)
    rec.turbo[d4k5], rec.turbo[d8s6] = 6000.0, 9000.0
    rec.gates[d4k5], rec.gate_ok[d4k5] = 44.0, True
    rec.gates[d8s6], rec.gate_ok[d8s6] = 37.0, False
    nlm_key = (6, 2, True, False)
    rec.nlm_turbo[nlm_key] = 1000.0
    rec.nlm_gates[nlm_key], rec.nlm_gate_ok[nlm_key] = 40.5, True
    out = _emit(rec)
    assert out["value"] == 200.0
    assert out["best_gated_turbo_4k_mpix_s"] == 6000.0  # not the ungated 9000
    assert out["best_gated_nlm_turbo_4k_mpix_s"] == 1000.0
    assert out["turbo_d8s6_gate_ok"] is False
    assert out["turbo_d8s6_4k_mpix_s"] == 9000.0  # published, just ungated
    assert out["turbo_d4k5_gate_ok"] is True
    assert out["nlm_turbo_s6disk_4k_db_vs_exact"] == 40.5


def test_exact_check_failures_zero_all_headlines():
    bench = _load_bench()
    rec = bench._Record()
    rec.out["bilateral_4k_mpix_s"] = 400.0
    rec.out["nlm_4k_mpix_s"] = 100.0
    key = (4, 5, None)
    rec.turbo[key], rec.gates[key], rec.gate_ok[key] = 6000.0, 44.0, True
    rec.failures.append("bilateral:12.0dB")
    out = _emit(rec)
    assert out["value"] == 0.0
    assert out["best_gated_turbo_4k_mpix_s"] == 0.0
    assert out["exact_check_failures"] == ["bilateral:12.0dB"]


def test_nlm_headline_row_zeroed_without_gate():
    """An NLM turbo row whose gate never ran is published but is not
    gate_ok and never carries the best-gated field."""
    bench = _load_bench()
    rec = bench._Record()
    rec.nlm_turbo[(7, 2, False, False)] = 800.0  # gate never measured
    out = _emit(rec)
    assert out["nlm_turbo_4k_mpix_s"] == 800.0
    assert out["nlm_turbo_gate_ok"] is False
    assert out["best_gated_nlm_turbo_4k_mpix_s"] == 0.0


def test_phases_skip_on_deadline_and_checkpoint(monkeypatch):
    bench = _load_bench()
    rec = bench._Record()
    phases = bench._Phases(rec)
    calls = []
    monkeypatch.setattr(bench, "_remaining", lambda: 10.0)  # below any est
    buf = io.StringIO()
    with redirect_stdout(buf):
        ran = phases.run("late_phase", lambda: calls.append(1), est_s=60)
    assert not ran and not calls
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 1  # the checkpoint record still printed
    out = json.loads(lines[0])
    assert any("skipped (deadline" in e for e in out["phase_errors"])
    assert out["degraded"] is True


def test_phases_fence_failure_and_reprobe(monkeypatch):
    """A phase that raises is noted and fenced; there is no backend re-probe
    (block_until_ready waits for the card), so the next phase still runs."""
    bench = _load_bench()
    rec = bench._Record()
    phases = bench._Phases(rec)
    monkeypatch.setattr(bench, "_remaining", lambda: 1000.0)

    def boom():
        raise RuntimeError("kernel exploded")

    ran = []
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert not phases.run("p1", boom, est_s=10)
        assert phases.run("p2", lambda: ran.append(1), est_s=10)
    assert ran == [1]
    out = json.loads(buf.getvalue().splitlines()[-1])
    assert out["phase_errors"] == ["p1: RuntimeError: kernel exploded"]


def test_tag_naming():
    bench = _load_bench()
    assert bench._Record._tag(2, 6, None) == "turbo_d2"
    assert bench._Record._tag(2, 5, None) == "turbo_d2k5"
    assert bench._Record._tag(8, 6, 6.0) == "turbo_d8s6"

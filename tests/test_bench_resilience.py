"""bench.py resilience contract: `main()` prints a full JSON checkpoint line
after every phase -- the last line is the record -- with an "error" field
instead of a traceback when the measurement explodes, and a mid-run phase
failure degrades the record instead of blanking it.

bench.py is loaded by path (it lives at the repo root, not in the package)
and never touches jax at import time, so these tests stay CPU-only and fast.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

_BENCH_PATH = Path(__file__).resolve().parent.parent / "bench.py"
_spec = importlib.util.spec_from_file_location("bench_under_test", _BENCH_PATH)
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)


def _run_main_and_parse(capsys):
    """Run the benchmark in-process; parse the TAIL checkpoint."""
    bench.main()
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert lines, "bench must print at least the initial checkpoint"
    for line in lines:  # every checkpoint must be independently parseable
        json.loads(line)
    return json.loads(lines[-1])


def test_emits_error_json_when_measurement_explodes(capsys, monkeypatch):
    def boom(rec, phases):
        raise RuntimeError("compile failed")

    monkeypatch.setattr(bench, "_measure", boom)
    out = _run_main_and_parse(capsys)
    assert out["value"] == 0.0
    assert "compile failed" in out["error"]
    assert out["degraded"] is True


def test_phase_failure_degrades_but_continues(capsys, monkeypatch):
    monkeypatch.setattr(bench, "_remaining", lambda: 1000.0)
    rec = bench._Record()
    phases = bench._Phases(rec)
    ran = []
    assert not phases.run("p1", lambda: (_ for _ in ()).throw(ValueError("x")))
    assert phases.run("p2", lambda: ran.append("p2"))
    assert ran == ["p2"]
    assert rec.out["phase_errors"] == ["p1: ValueError: x"]
    # Each phase boundary emitted a parseable checkpoint line.
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 2
    assert json.loads(lines[-1])["degraded"] is True


def test_smoke_run_names_its_device():
    """BENCH_SMOKE=1 runs every phase at tiny shapes on the CPU in one
    process; the record names the device it ran on, so a CPU number can
    never pass for a GPU one."""
    env = dict(os.environ, BENCH_SMOKE="1", JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-u", str(_BENCH_PATH)],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=str(_BENCH_PATH.parent),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["device"]["platform"] == "cpu"
    assert out["exact_check_failures"] == []
    assert "phase_errors" not in out, out.get("phase_errors")
    assert out["bilateral_4k_mpix_s"] > 0 and out["nlm_4k_mpix_s"] > 0

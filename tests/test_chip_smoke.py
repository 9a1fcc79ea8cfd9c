"""chip_smoke.py on the CPU: its phase functions at tiny shapes (kernels in
interpret mode), and its refusal to run without a GPU or without the
repository beside it."""

from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

_PATH = Path(__file__).resolve().parent.parent / "chip_smoke.py"
_spec = importlib.util.spec_from_file_location("chip_smoke_under_test", _PATH)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

H, W = 40, 48
# phase_gates' readings, in the order it takes them.
GATED = (
    "bilateral_d2", "bilateral_d4", "layers_d2", "layers_d4",
    "nlm_stride2", "nlm_stride2_disk",
)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("smoke")
    target, clean = chip_smoke.make_data(str(root), H, W, frames=3)
    return target, clean, str(root / "out")


def _run_script(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(args[0]), *args[1:]],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def test_exits_nonzero_without_gpu(tmp_path):
    """On a machine where JAX finds no GPU: nonzero exit, no result line."""
    r = _run_script([_PATH], cwd=str(_PATH.parent))
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_exits_nonzero_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(_PATH, lone)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run(
        [sys.executable, str(lone)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phase_oracle_tiny():
    out = chip_smoke.phase_oracle(24, 32)
    assert set(out) == {"bilateral", "layers", "nlm", "nlm_frames_masked"}
    assert all(v <= 1.0 for v in out.values())


def test_make_data_and_battery(dataset):
    """The six device configurations through cli.main at a tiny size: every
    output reopens and beats the noisy input's PSNR."""
    target, clean, out_dir = dataset
    assert clean.shape == (H, W, 4)
    out = chip_smoke.phase_battery(target, clean, out_dir)
    for key in chip_smoke.DEVICE_CONFIGS:
        assert out[key] > out["noisy_db"]


def test_phase_paths_tiny(dataset):
    target, clean, out_dir = dataset
    out = chip_smoke.phase_paths(target, clean, out_dir)
    assert set(out) == {"batch_frames", "turbo2", "turbo4", "turbo2_disk"}


def test_phase_gates_tiny(monkeypatch):
    """The gate phase computes every approximate mode's dB vs exact (the
    40 dB bar is for 1080p; at this size only the wiring is checked)."""
    monkeypatch.setattr(chip_smoke, "GATE_DB", 0.0)
    out = chip_smoke.phase_gates(H, W)
    assert set(out) == set(GATED)
    assert all(np.isfinite(v) and v > 20 for v in out.values())


def test_phase_gates_raises_below_gate(monkeypatch):
    monkeypatch.setattr(chip_smoke, "GATE_DB", 1e9)
    with pytest.raises(RuntimeError, match="gate"):
        chip_smoke.phase_gates(H, W)


@pytest.mark.parametrize("low", range(len(GATED)))
def test_phase_gates_gates_every_mode(monkeypatch, low):
    """Every mode is gated at the size asked for: one reading just under
    40 dB fails the phase and is named."""
    calls = []

    def fake_psnr(a, b):  # readings come in GATED order
        calls.append(a.shape)
        return 39.99 if len(calls) - 1 == low else 50.0

    monkeypatch.setattr(chip_smoke, "_psnr", fake_psnr)
    monkeypatch.setattr(chip_smoke, "GATE_DB", 40.0)
    with pytest.raises(RuntimeError, match=GATED[low]):
        chip_smoke.phase_gates(H, W)
    assert all(shape[:2] == (H, W) for shape in calls)


def test_phase_timing_tiny():
    out = chip_smoke.phase_timing(sizes=((16, 24),), frames=2, reps=1)
    assert set(out) == {"bilateral_16p", "layers_one_16p", "nlm_one_16p", "nlm_2frames_16p"}
    assert all(v["kernel_ms"] > 0 and v["xla_ms"] > 0 for v in out.values())


def test_phase_e2e_tiny(dataset):
    """Each kernel configuration and its linear (XLA) twin run through the
    Session; both execution times are reported."""
    target, _, out_dir = dataset
    out = chip_smoke.phase_e2e(target, out_dir, reps=2)
    assert set(out) == set(chip_smoke.TILED_CONFIGS)
    for v in out.values():
        for side in ("kernel_exec_ms", "xla_exec_ms"):
            t = v[side]
            assert 0 < t["min"] <= t["median"] <= t["max"]


def test_overlap_summary():
    """Uploads that run while an NLM kernel runs count as overlapped."""
    events = [
        ("MemcpyH2D", 0, 10, "/device:GPU:0"),
        ("nlm_accumulate", 5, 30, "/device:GPU:0"),
        ("MemcpyHtoD", 40, 50, "/device:GPU:0"),
        ("fusion", 50, 60, "/device:GPU:0"),
        ("load_frame", 0, 100, "/host:CPU"),
        ("MemcpyH2D", 0, 30, "/host:CPU"),
    ]
    s = chip_smoke.overlap_summary(events)
    assert s["uploads"] == 2 and s["nlm_kernels"] == 1
    assert s["uploads_overlapping_nlm"] == 1
    assert s["overlapped_ms"] == pytest.approx(5e-6)
    assert s["host_load_frames"] == 1
    assert s["host_load_frame_ms"] == pytest.approx(1e-4)


def test_phase_multi_on_virtual_devices(dataset):
    """The four-device path on four virtual CPU devices: each sharded
    config matches the single-device Session."""
    target, _, out_dir = dataset
    out = chip_smoke.phase_multi(target, out_dir, mesh=(2, 2))
    assert set(out) == set(chip_smoke.TILED_CONFIGS)
    assert all(v["worst_ratio"] <= 1.0 for v in out.values())

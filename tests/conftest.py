"""Test session config: run everything on a virtual 8-device CPU mesh.

Multi-device sharding tests need multiple devices; CI has no GPUs, so we use
XLA's host-platform device-count override (the fake backend the reference
lacks -- SURVEY.md section 4). Kernels run in Pallas interpret mode there.
Must be set before jax is imported anywhere, hence this conftest.

Tests marked `gpu` need the card: the `gpu_backend` fixture skips them
unless JAX's default backend is a GPU (decided when the test runs, never at
import or collection time, so every xdist worker collects the same tests).
Run them on the card with `IDF_GPU_TESTS=1 python -m pytest tests -m gpu`.
"""

import os

if os.environ.get("IDF_GPU_TESTS") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("IDF_NO_PROGRESS", "1")

import numpy as np
import pytest


@pytest.fixture
def gpu_backend():
    """Skip unless JAX runs on a GPU (tests marked `gpu` use this)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with IDF_GPU_TESTS=1 on the card)")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def small_image(rng):
    """A small piecewise-smooth noisy RGBA test image (float32, [0, 1])."""
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [
            0.5 + 0.4 * np.sin(xx / 9.0),
            0.5 + 0.4 * np.cos(yy / 7.0),
            np.where(xx > w / 2, 0.8, 0.2).astype(np.float32),
            np.ones((h, w), np.float32),
        ],
        axis=-1,
    )
    noise = rng.normal(0, 0.05, (h, w, 4)).astype(np.float32)
    noise[..., 3] = 0.0
    return np.clip(base + noise, 0.0, 1.0).astype(np.float32)

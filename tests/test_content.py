"""synthetic_render_device must be the same scene as synthetic_render:
the device-evaluated generator makes benchmark content without a host->device
upload, and the two must agree so content stays comparable."""

from __future__ import annotations

import numpy as np

from image_denoising_filter.utils.content import (
    synthetic_render,
    synthetic_render_device,
)


def test_device_generator_matches_host():
    host = synthetic_render(96, 160, seed=1)
    dev = np.asarray(synthetic_render_device(96, 160, seed=1))
    assert dev.shape == host.shape == (96, 160, 4)
    assert dev.dtype == np.float32
    # Same parameter draws, same elementwise math: float32 rounding only.
    assert np.max(np.abs(dev - host)) < 2e-6


def test_device_generator_seeds_differ():
    a = np.asarray(synthetic_render_device(64, 128, seed=1))
    b = np.asarray(synthetic_render_device(64, 128, seed=2))
    assert np.max(np.abs(a - b)) > 0.05


def test_device_generator_range_and_alpha():
    img = np.asarray(synthetic_render_device(64, 128, seed=3))
    assert img.min() >= 0.0 and img.max() <= 1.0
    assert np.all(img[..., 3] == 1.0)

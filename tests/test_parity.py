"""Quality-parity gates and auxiliary feature tests.

The BASELINE.json parity metric is >= 59 dB PSNR vs the CPU bilateral
reference output; these tests enforce it (far exceeded) plus the aux
subsystems: debug weights dump, dataset generator, progress plumbing.
"""

import io
import os
import sys

import numpy as np
import pytest

from image_denoising_filter.config import (
    BilateralParams,
    CpuBilateralParams,
    NlmParams,
    RunConfig,
)
from image_denoising_filter.ops import bilateral, bilateral_xla
from image_denoising_filter.ops import reference as ref
from image_denoising_filter.runtime import Session
from image_denoising_filter.utils import imageio


def test_psnr_parity_vs_cpu_reference(rng):
    """Our kernel in CPU-params mode vs the CPU reference oracle: the
    BASELINE >=59 dB gate, on the interior (the CPU path zeroes the border)."""
    img = rng.uniform(0, 1, (48, 64, 4)).astype(np.float32)
    cp = CpuBilateralParams()
    kernel_params = BilateralParams(
        radius=cp.radius,
        sigma_spatial=cp.sigma_spatial,
        sigma_color=cp.sigma_color,
        blue_bug=cp.blue_bug,
    )
    got = np.asarray(bilateral_xla(img, kernel_params))
    want = ref.cpu_bilateral_reference(img, cp)
    r = cp.radius
    interior = (slice(r, -r), slice(r, -r), slice(0, 3))
    psnr = ref.psnr(got[interior], want[interior])
    assert psnr >= 59.0, f"PSNR parity {psnr:.1f} dB < 59 dB"
    assert psnr >= 100.0  # in practice it's float-roundoff-level


def test_native_cpu_psnr_parity(rng):
    native = pytest.importorskip("image_denoising_filter.utils.native")
    if not native.available():
        pytest.skip("native lib not built")
    img = rng.uniform(0, 1, (48, 64, 4)).astype(np.float32)
    got = native.cpu_bilateral(img, num_threads=4)
    want = ref.cpu_bilateral_reference(img)
    r = CpuBilateralParams().radius
    interior = (slice(r, -r), slice(r, -r), slice(0, 3))
    assert ref.psnr(got[interior], want[interior]) >= 59.0


def test_debug_weights_dump(tmp_path, capsys):
    """Session(debug_weights=True) prints sampled accumulator values in the
    reference's dump format (src/main.cpp:1628-1647)."""
    rng = np.random.default_rng(0)
    root = str(tmp_path)
    for i in range(2):
        imageio.save(
            f"{root}/f_{i:04d}.png",
            rng.uniform(0, 1, (64, 64, 4)).astype(np.float32),
        )
    session = Session(
        f"{root}/f_0001.png",
        nlm_params=NlmParams(search_radius=2, patch_radius=1),
        output_dir=root,
        debug_weights=True,
    )
    session.run(RunConfig(nlm=True, multiframe=True))
    out = capsys.readouterr().out
    assert "=>" in out and "|" in out


def test_make_dataset_tool(tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    try:
        import make_dataset
    finally:
        sys.path.pop(0)
    out = str(tmp_path / "Animations" / "Box")
    rc = make_dataset.main([out, "--frames", "3", "--size", "32x48"])
    assert rc == 0
    frames = sorted(os.listdir(out))
    assert "Animation01_LDR_0000.png" in frames
    assert "RenderElements" in frames
    layers = os.listdir(os.path.join(out, "RenderElements"))
    assert len(layers) == 9  # 3 layers x 3 frames
    # And it's consumable by the full pipeline.
    from image_denoising_filter.utils import dataset

    ds = dataset.discover(
        f"{out}/Animation01_LDR_0001.png", multiframe=True, use_layers=True
    )
    assert len(ds.frames) == 4 and len(ds.layers) == 3


def test_make_dataset_hdr(tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    try:
        import make_dataset
    finally:
        sys.path.pop(0)
    out = str(tmp_path / "HdrBox")
    make_dataset.main([out, "--frames", "2", "--size", "32x48", "--hdr"])
    img, hdr = imageio.load(f"{out}/Animation01_HDR_0000.exr")
    assert hdr and float(img.max()) > 1.5  # genuinely HDR content

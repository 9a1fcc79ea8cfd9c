"""Oracle self-consistency tests: brute-force per-pixel loops (transcribed
literally from the reference GLSL/C++) vs the vectorized NumPy oracles.

The vectorized oracles in ops/reference.py are what every Pallas kernel is
tested against, so they themselves are validated here against direct
tap-by-tap transcriptions of shaders/bialteral.comp, bialteral_layers.comp,
nonlocal.comp, normalize.comp and the CPU path (src/main.cpp:1732-1921).
"""

import math

import numpy as np
import pytest

from image_denoising_filter.config import (
    BilateralParams,
    CpuBilateralParams,
    LayersParams,
    NlmParams,
)
from image_denoising_filter.ops import reference as ref


def _clamp_tap(img, y, x):
    h, w = img.shape[:2]
    return img[min(max(y, 0), h - 1), min(max(x, 0), w - 1)]


def _brute_bilateral(img, p: BilateralParams):
    """Literal transcription of shaders/bialteral.comp:29-81."""
    h, w, _ = img.shape
    out = np.zeros_like(img)
    for y in range(h):
        for x in range(w):
            center = img[y, x]
            norm, wc = 0.0, np.zeros(4, np.float64)
            for i in range(-p.radius, p.radius + 1):
                for j in range(-p.radius, p.radius + 1):
                    sd = math.sqrt(i * i + j * j)
                    sw = math.exp(-0.5 * (sd / p.sigma_spatial) ** 2)
                    cur = _clamp_tap(img, y + j, x + i)
                    cd = math.sqrt(
                        (center[0] - cur[0]) ** 2
                        + (center[1] - cur[1]) ** 2
                        + (0.0 if p.blue_bug else (center[2] - cur[2]) ** 2)
                    )
                    cw = math.exp(-0.5 * (cd / p.sigma_color) ** 2)
                    wc += cur * (sw * cw)
                    norm += sw * cw
            out[y, x] = wc / norm
    return out


def _brute_nlm(target, neigh, p: NlmParams):
    """Literal transcription of shaders/nonlocal.comp:30-65."""
    h, w, _ = target.shape
    wc = np.zeros((h, w, 4), np.float64)
    norm = np.full((h, w), p.norm_seed, np.float64)
    for cy in range(h):
        for cx in range(w):
            for y in range(cy - p.search_radius, cy + p.search_radius):
                for x in range(cx - p.search_radius, cx + p.search_radius):
                    ssd = 0.0
                    for j in range(-p.patch_radius, p.patch_radius):
                        for i in range(-p.patch_radius, p.patch_radius):
                            t = _clamp_tap(target, cy + j, cx + i)
                            n = _clamp_tap(neigh, y + j, x + i)
                            ssd += (
                                (t[0] - n[0]) ** 2
                                + (t[1] - n[1]) ** 2
                                + (t[2] - n[2]) ** 2
                            )
                    wgt = math.exp(-ssd / p.h**2)
                    wc[cy, cx] += _clamp_tap(neigh, y, x) * wgt
                    norm[cy, cx] += wgt
    return wc, norm


def test_bilateral_oracle_matches_brute_force(small_image):
    img = small_image[:12, :14]
    p = BilateralParams(radius=3)
    got = ref.bilateral_reference(img, p)
    want = _brute_bilateral(img.astype(np.float64), p)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_bilateral_oracle_blue_bug(small_image):
    img = small_image[:12, :14]
    p = BilateralParams(radius=3, blue_bug=True)
    got = ref.bilateral_reference(img, p)
    want = _brute_bilateral(img.astype(np.float64), p)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    # And the bug must actually change the output vs the fixed version.
    fixed = ref.bilateral_reference(img, BilateralParams(radius=3))
    assert not np.allclose(got, fixed)


def test_nlm_oracle_matches_brute_force(small_image):
    target = small_image[:10, :12]
    rng = np.random.default_rng(7)
    neigh = np.clip(
        target + rng.normal(0, 0.03, target.shape).astype(np.float32), 0, 1
    ).astype(np.float32)
    p = NlmParams(search_radius=2, patch_radius=1)
    wc, norm = ref.nlm_reference(target, neigh, p)
    bwc, bnorm = _brute_nlm(
        target.astype(np.float64), neigh.astype(np.float64), p
    )
    np.testing.assert_allclose(wc, bwc, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(norm, bnorm, rtol=2e-5, atol=2e-6)


def test_layers_oracle_guide_semantics(small_image):
    """Weights must come from the layer, colors from the target
    (shaders/bialteral_layers.comp:46-55): with a *constant* layer, every tap
    weight collapses to the spatial Gaussian -- a plain Gaussian blur of the
    target."""
    target = small_image[:16, :16]
    layer = np.full_like(target, 0.5)
    p = LayersParams(radius=3)
    wc, norm = ref.cross_bilateral_layers_reference(target, layer, p)

    r = p.radius
    sw = np.array(
        [
            [math.exp(-0.5 * (i * i + j * j) / p.sigma_spatial**2) for i in range(-r, r + 1)]
            for j in range(-r, r + 1)
        ]
    )
    padded = np.pad(target, ((r, r), (r, r), (0, 0)), mode="edge")
    want = np.zeros_like(target)
    for j in range(2 * r + 1):
        for i in range(2 * r + 1):
            want += padded[j : j + 16, i : i + 16] * sw[j, i]
    np.testing.assert_allclose(wc, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(norm, np.full((16, 16), sw.sum()), rtol=1e-5)


def test_normalize_sentinel():
    wc = np.ones((4, 4, 4), np.float32) * 2.0
    norm = np.ones((4, 4), np.float32) * 4.0
    norm[1, 2] = 0.0
    out = ref.normalize_reference(wc, norm)
    np.testing.assert_allclose(out[0, 0], 0.5)
    np.testing.assert_allclose(out[1, 2], [1.0, 0.0, 1.0, 1.0])


def test_cpu_reference_border_and_alpha(small_image):
    out = ref.cpu_bilateral_reference(small_image)
    r = CpuBilateralParams().radius
    # Border stays zero (src/main.cpp:1816, 1823-1828)...
    assert np.all(out[: r, :] == 0.0) and np.all(out[:, : r] == 0.0)
    assert np.all(out[-r + 1 :, :] == 0.0) and np.all(out[:, -r + 1 :] == 0.0)
    # ...interior alpha forced to 1 (src/main.cpp:1864).
    assert np.all(out[r : -r + 1 or None, r : -r + 1 or None, 3] == 1.0)


def test_cpu_reference_is_blue_bugged(small_image):
    """The CPU path's color distance ignores blue entirely (src/main.cpp:1850):
    changing only the blue channel of the input must not change the weights."""
    img = small_image.copy()
    img2 = img.copy()
    img2[..., 2] = 1.0 - img2[..., 2]
    a = ref.cpu_bilateral_reference(img)
    b = ref.cpu_bilateral_reference(img2)
    # Red/green outputs identical => weights unaffected by blue.
    np.testing.assert_allclose(a[..., :2], b[..., :2], rtol=1e-6)


def test_psnr():
    a = np.zeros((8, 8))
    assert ref.psnr(a, a) == float("inf")
    b = a + 0.1
    assert abs(ref.psnr(a, b) - 20.0) < 1e-6

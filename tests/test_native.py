"""Native library (C++/OpenMP) vs Python implementations.

Skipped when libidf_native.so isn't built (`make -C native`).
"""

import numpy as np
import pytest

from image_denoising_filter.config import CpuBilateralParams
from image_denoising_filter.ops import reference as ref
from image_denoising_filter.utils import exr, png

native = pytest.importorskip("image_denoising_filter.utils.native")
if not native.available():
    pytest.skip("libidf_native.so not built", allow_module_level=True)


def test_native_cpu_bilateral_matches_oracle(rng):
    img = rng.uniform(0, 1, (48, 56, 4)).astype(np.float32)
    got = native.cpu_bilateral(img, num_threads=2)
    want = ref.cpu_bilateral_reference(img)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_native_cpu_bilateral_threads_deterministic(rng):
    img = rng.uniform(0, 1, (40, 40, 4)).astype(np.float32)
    a = native.cpu_bilateral(img, num_threads=1)
    b = native.cpu_bilateral(img, num_threads=8)
    np.testing.assert_array_equal(a, b)


def test_native_png_roundtrip(rng):
    img = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    data = native.png_encode(img)
    assert np.array_equal(native.png_decode(data), img)
    # Cross-decode: Python decoder reads native encodes and vice versa.
    assert np.array_equal(png.decode(data), img)
    assert np.array_equal(native.png_decode(png.encode(img)), img)


def test_native_png_decodes_python_filters(rng):
    """Native decoder handles all filter choices the Python encoder makes."""
    yy, xx = np.mgrid[0:64, 0:80]
    smooth = np.stack([xx % 256, yy % 256, (xx * yy) % 256, np.full_like(xx, 255)], -1)
    data = png.encode(smooth.astype(np.uint8))
    assert np.array_equal(native.png_decode(data), smooth)


@pytest.mark.parametrize("compression", [0, 2, 3])
@pytest.mark.parametrize("half", [False, True])
def test_native_exr_roundtrip(rng, compression, half):
    img = rng.normal(0, 2, (21, 33, 4)).astype(np.float32)
    data = native.exr_encode(img, half=half, compression=compression)
    got = native.exr_decode(data)
    want = img.astype(np.float16).astype(np.float32) if half else img
    np.testing.assert_array_equal(got, want)
    # Cross-decode both directions.
    np.testing.assert_array_equal(exr.decode(data), want)
    np.testing.assert_array_equal(
        native.exr_decode(exr.encode(img, half=half, compression=compression)), want
    )


def test_native_exr_half_conversion_edge_cases():
    vals = np.array(
        [[[0.0, -0.0, 65504.0, 1e-8]], [[np.inf, -np.inf, 1.0009766, 2.0]]],
        np.float32,
    )
    data = native.exr_encode(np.tile(vals, (1, 1, 2))[:, :, :4], half=True, compression=0)
    got = native.exr_decode(data)
    want = np.tile(vals, (1, 1, 2))[:, :, :4].astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_native_rejects_garbage():
    with pytest.raises(ValueError):
        native.png_decode(b"not a png")
    with pytest.raises(ValueError):
        native.exr_decode(b"not an exr")


def _decode_must_not_crash(blob: bytes) -> None:
    try:
        native.exr_decode(blob)
    except ValueError:
        pass  # rejecting is fine; crashing/OOB is not


def test_native_exr_truncation_is_safe(rng):
    """Every truncation of a valid EXR either decodes or raises ValueError."""
    img = rng.normal(0, 1, (20, 24, 4)).astype(np.float32)
    data = native.exr_encode(img, half=False, compression=3)
    for n in range(0, len(data), 7):
        _decode_must_not_crash(data[:n])


def test_native_exr_corrupt_offsets_and_block_headers(rng):
    """Bogus block offsets / block y0 (the raw-pointer hazards) are rejected."""
    img = rng.normal(0, 1, (40, 16, 4)).astype(np.float32)
    data = bytearray(native.exr_encode(img, half=True, compression=2))
    # The offset table sits right before the first block; find it by locating
    # the first block header (y0 == 0 as int32 at the first offset). Rather
    # than parse, just smash every aligned int64 in the file with hostile
    # values -- includes all offset-table entries and block y0/size fields.
    hostile = [2**62, -1, len(data) - 1, len(data) + 10**6, -(2**31), 2**31 - 1]
    for pos in range(8, min(len(data) - 8, 400), 8):
        for v in hostile:
            mut = bytearray(data)
            mut[pos : pos + 8] = int(v & (2**64 - 1)).to_bytes(8, "little")
            _decode_must_not_crash(bytes(mut))


def test_native_exr_random_mutation_fuzz(rng):
    img = rng.normal(0, 1, (16, 16, 4)).astype(np.float32)
    base = native.exr_encode(img, half=False, compression=2)
    for _ in range(300):
        mut = bytearray(base)
        for _ in range(int(rng.integers(1, 8))):
            mut[int(rng.integers(0, len(mut)))] = int(rng.integers(0, 256))
        _decode_must_not_crash(bytes(mut))


def test_native_png_random_mutation_fuzz(rng):
    img = rng.integers(0, 256, (16, 16, 4), dtype=np.uint8)
    base = native.png_encode(img)
    for _ in range(300):
        mut = bytearray(base)
        for _ in range(int(rng.integers(1, 8))):
            mut[int(rng.integers(0, len(mut)))] = int(rng.integers(0, 256))
        try:
            native.png_decode(bytes(mut))
        except ValueError:
            pass

"""Property-based round-trip tests (hypothesis): codecs and quantization must
hold for arbitrary shapes and contents, not just the fixtures."""

import numpy as np
from hypothesis import given, settings, strategies as st

from image_denoising_filter.utils import exr, imageio, png


@st.composite
def _rgba_u8(draw):
    h = draw(st.integers(1, 40))
    w = draw(st.integers(1, 40))
    seed = draw(st.integers(0, 2**31 - 1))
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)


@st.composite
def _rgba_f32(draw):
    h = draw(st.integers(1, 24))
    w = draw(st.integers(1, 24))
    seed = draw(st.integers(0, 2**31 - 1))
    scale = draw(st.sampled_from([1.0, 100.0, 1e-4]))
    rng = np.random.default_rng(seed)
    return (rng.normal(0, scale, (h, w, 4))).astype(np.float32)


@settings(max_examples=25, deadline=None)
@given(_rgba_u8())
def test_png_roundtrip_property(img):
    assert np.array_equal(png.decode(png.encode(img)), img)


@settings(max_examples=25, deadline=None)
@given(_rgba_f32(), st.sampled_from([0, 2, 3]))
def test_exr_roundtrip_property(img, compression):
    out = exr.decode(exr.encode(img, compression=compression))
    np.testing.assert_array_equal(out, img)


@settings(max_examples=25, deadline=None)
@given(_rgba_u8())
def test_ldr_quantize_roundtrip_property(img):
    """byte -> float -> byte is the identity for every byte value
    (src/main.cpp:1125-1128 up, 97-102 down)."""
    assert np.array_equal(imageio.quantize(imageio.to_float(img)), img)


@settings(max_examples=15, deadline=None)
@given(_rgba_u8())
def test_native_codecs_agree_property(img):
    try:
        from image_denoising_filter.utils import native

        if not native.available():
            return
    except ImportError:
        return
    data_py = png.encode(img)
    assert np.array_equal(native.png_decode(data_py), img)
    assert np.array_equal(png.decode(native.png_encode(img)), img)

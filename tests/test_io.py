"""PNG/EXR codec and LDR quantization round-trip tests."""

import os

import numpy as np
import pytest

from image_denoising_filter.utils import exr, imageio, png


def test_png_roundtrip(rng):
    img = rng.integers(0, 256, (33, 47, 4), dtype=np.uint8)
    assert np.array_equal(png.decode(png.encode(img)), img)


def test_png_roundtrip_large_smooth(rng):
    yy, xx = np.mgrid[0:128, 0:200]
    img = np.stack([xx % 256, yy % 256, (xx + yy) % 256, np.full_like(xx, 255)], -1).astype(np.uint8)
    assert np.array_equal(png.decode(png.encode(img)), img)


def test_png_decode_rgb_and_gray():
    # Hand-build an RGB (color type 2) PNG via our encoder pieces.
    import struct
    import zlib

    h, w = 5, 7
    rgb = (np.arange(h * w * 3, dtype=np.uint8)).reshape(h, w, 3)
    lines = b""
    for y in range(h):
        lines += b"\x00" + rgb[y].tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    data = (
        b"\x89PNG\r\n\x1a\n"
        + png._chunk(b"IHDR", ihdr)
        + png._chunk(b"IDAT", zlib.compress(lines))
        + png._chunk(b"IEND", b"")
    )
    out = png.decode(data)
    assert out.shape == (h, w, 4)
    assert np.array_equal(out[..., :3], rgb)
    assert np.all(out[..., 3] == 255)


def test_png_all_filters_decode(rng):
    """Force each filter type on encode and check decode inverts it."""
    import struct
    import zlib

    h, w = 9, 11
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    raw = img.reshape(h, w * 4).astype(np.int32)
    stride, bpp = w * 4, 4
    lines = bytearray()
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        f = y % 5
        row = raw[y]
        if f == 0:
            filt = row
        elif f == 1:
            filt = (row - np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])) & 0xFF
        elif f == 2:
            filt = (row - prior) & 0xFF
        elif f == 3:
            left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
            filt = (row - ((left + prior) >> 1)) & 0xFF
        else:
            filt = np.empty(stride, np.int32)
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                b = prior[x]
                c = prior[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                filt[x] = (row[x] - pred) & 0xFF
        lines.append(f)
        lines += filt.astype(np.uint8).tobytes()
        prior = row
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    data = (
        b"\x89PNG\r\n\x1a\n"
        + png._chunk(b"IHDR", ihdr)
        + png._chunk(b"IDAT", zlib.compress(bytes(lines)))
        + png._chunk(b"IEND", b"")
    )
    assert np.array_equal(png.decode(data), img)


@pytest.mark.parametrize("compression", [0, 2, 3])
@pytest.mark.parametrize("half", [False, True])
def test_exr_roundtrip(rng, compression, half):
    img = rng.normal(0, 2.0, (21, 33, 4)).astype(np.float32)
    data = exr.encode(img, half=half, compression=compression)
    out = exr.decode(data)
    if half:
        np.testing.assert_array_equal(out, img.astype(np.float16).astype(np.float32))
    else:
        np.testing.assert_array_equal(out, img)


def test_exr_alpha_preserved(rng, tmp_path):
    """README.md:57-59: .exr saved with alpha channel."""
    img = rng.uniform(0, 4, (16, 16, 4)).astype(np.float32)
    p = str(tmp_path / "x.exr")
    exr.write(p, img)
    out = exr.read(p)
    np.testing.assert_array_equal(out[..., 3], img[..., 3])


def test_quantize_unclamped_wrap():
    """The reference's unclamped (unsigned char)(255*x) cast wraps values > 1
    (src/main.cpp:97-102)."""
    x = np.array([[[0.0, 0.5, 1.0, 1.5]]], np.float32)
    out = imageio.quantize(x)
    assert out.tolist() == [[[0, 127, 255, int(np.trunc(1.5 * 255)) % 256]]]
    clamped = imageio.quantize(x, clamp=True)
    assert clamped.tolist() == [[[0, 127, 255, 255]]]


def test_ldr_roundtrip_semantics(tmp_path, rng):
    """byte -> *1/255 float -> *255 trunc byte must be the identity
    (src/main.cpp:1125-1128, 97-102)."""
    b = rng.integers(0, 256, (8, 8, 4), dtype=np.uint8)
    again = imageio.quantize(imageio.to_float(b))
    assert np.array_equal(b, again)


def test_load_save_dispatch(tmp_path, rng):
    imgf = rng.uniform(0, 1, (12, 12, 4)).astype(np.float32)
    ppng = str(tmp_path / "a.png")
    pexr = str(tmp_path / "a.exr")
    imageio.save(ppng, imgf)
    imageio.save(pexr, imgf)
    lp, hdr_p = imageio.load(ppng)
    le, hdr_e = imageio.load(pexr)
    assert not hdr_p and hdr_e
    np.testing.assert_array_equal(le, imgf)
    assert np.max(np.abs(lp - imgf)) <= 1.0 / 255.0 + 1e-6


# -- Codec breadth: files lodepng/tinyexr would accept ------------------------

_ORACLE = os.path.join(os.path.dirname(__file__), "..", "native", "exr_oracle")


def _oracle_write(path, img, comp, half):
    import subprocess

    h, w, _ = img.shape
    subprocess.run(
        [_ORACLE, "write", path, str(w), str(h), str(comp), str(int(half))],
        input=np.ascontiguousarray(img, np.float32).tobytes(),
        check=True,
    )


def _oracle_read(path):
    import subprocess

    out = subprocess.run([_ORACLE, "read", path], capture_output=True, check=True)
    return np.frombuffer(out.stdout, np.float32)


@pytest.mark.skipif(not os.path.exists(_ORACLE), reason="make -C native oracle")
@pytest.mark.parametrize("comp", [1, 4, 5], ids=["rle", "piz", "pxr24"])
@pytest.mark.parametrize("half", [True, False], ids=["half", "float"])
def test_exr_decode_matches_system_openexr(tmp_path, rng, comp, half):
    """RLE/PIZ/PXR24 decode: bit-exact against ground truth produced AND read
    back by the system OpenEXR library (native/exr_oracle.cpp)."""
    for h, w in [(20, 24), (33, 17), (70, 40), (1, 5)]:
        img = rng.normal(0, 1, (h, w, 4)).astype(np.float32)
        p = str(tmp_path / f"o_{comp}_{half}_{h}x{w}.exr")
        _oracle_write(p, img, comp, half)
        want = _oracle_read(p).reshape(h, w, 4)
        got = exr.read(p)
        np.testing.assert_array_equal(got, want)
        # the full loader path (native codec falls back per-file) agrees
        loaded, hdr = imageio.load(p)
        assert hdr
        np.testing.assert_array_equal(loaded, want)


@pytest.mark.skipif(not os.path.exists(_ORACLE), reason="make -C native oracle")
def test_exr_zip_matches_system_openexr(tmp_path, rng):
    """Our ZIP/ZIPS decode also agrees with the system library byte-for-byte."""
    img = rng.normal(0, 1, (40, 22, 4)).astype(np.float32)
    for comp in (2, 3):
        p = str(tmp_path / f"z{comp}.exr")
        _oracle_write(p, img, comp, False)
        np.testing.assert_array_equal(exr.read(p), _oracle_read(p).reshape(40, 22, 4))


@pytest.mark.skipif(not os.path.exists(_ORACLE), reason="make -C native oracle")
@pytest.mark.parametrize("comp", [0, 3, 4], ids=["none", "zip", "piz"])
@pytest.mark.parametrize("mip", [0, 1, 2], ids=["one_level", "mipmap", "ripmap"])
def test_exr_tiled_decode_matches_system_openexr(tmp_path, rng, comp, mip):
    """Tiled single-part EXR decode (tinyexr's loader accepts these): tiles of
    several shapes, partial edge tiles, ONE_LEVEL / MIPMAP / RIPMAP (only
    level (0,0) feeds the image, like tinyexr, but the RIPMAP offset-table
    level-pair enumeration must be walked correctly to find it)."""
    import subprocess

    for (h, w), (txs, tys) in [((40, 56), (16, 16)), ((33, 17), (32, 8)),
                               ((64, 64), (64, 64))]:
        img = rng.normal(0, 1, (h, w, 4)).astype(np.float32)
        p = str(tmp_path / f"t_{comp}_{mip}_{h}x{w}.exr")
        subprocess.run(
            [_ORACLE, "writetiled", p, str(w), str(h), str(comp),
             str(txs), str(tys), str(mip)],
            input=np.ascontiguousarray(img, np.float32).tobytes(),
            check=True,
        )
        want = _oracle_read(p).reshape(h, w, 4)
        np.testing.assert_array_equal(exr.read(p), want)
        loaded, hdr = imageio.load(p)
        assert hdr
        np.testing.assert_array_equal(loaded, want)


def _pil_png(arr_or_img, **save_kw):
    import io

    from PIL import Image

    im = arr_or_img if isinstance(arr_or_img, Image.Image) else Image.fromarray(arr_or_img)
    buf = io.BytesIO()
    im.save(buf, "PNG", **save_kw)
    return buf.getvalue()


def test_png_decode_interlaced(rng):
    a = rng.integers(0, 256, (37, 53, 4), np.uint8)
    data = _pil_png(a, interlace=True)
    assert np.array_equal(png.decode(data), a)


def test_png_decode_16bit_gray(rng):
    from PIL import Image

    g16 = rng.integers(0, 65536, (25, 31)).astype(np.uint16)
    im = Image.new("I;16", (31, 25))
    im.putdata([int(v) for v in g16.ravel()])
    data = _pil_png(im)
    got = png.decode(data)
    assert np.array_equal(got[..., 0], (g16 >> 8).astype(np.uint8))
    assert np.all(got[..., 3] == 255)


def test_png_decode_16bit_rgb_manual(rng):
    """16-bit RGB (no PIL writer): hand-built file, PIL cross-checks ours."""
    import io
    import struct
    import zlib

    from PIL import Image

    h, w = 9, 7
    rgb16 = rng.integers(0, 65536, (h, w, 3)).astype(np.uint16)
    lines = bytearray()
    for y in range(h):
        lines.append(0)
        lines += rgb16[y].astype(">u2").tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0)
    data = (
        b"\x89PNG\r\n\x1a\n"
        + png._chunk(b"IHDR", ihdr)
        + png._chunk(b"IDAT", zlib.compress(bytes(lines)))
        + png._chunk(b"IEND", b"")
    )
    got = png.decode(data)
    assert np.array_equal(got[..., :3], (rgb16 >> 8).astype(np.uint8))
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    assert np.array_equal(got, pil)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_png_decode_low_bitdepth_gray(rng, bits):
    from PIL import Image

    lv = (1 << bits) - 1
    vals = rng.integers(0, lv + 1, (20, 30)).astype(np.uint8)
    scaled = (vals * (255 // lv)).astype(np.uint8)
    if bits == 1:
        data = _pil_png(Image.fromarray(vals > 0))
    else:
        im = Image.fromarray(vals, "L").convert("P")
        im.putpalette([v for g in range(256) for v in (g, g, g)])
        data = _pil_png(im, bits=bits)
        got = png.decode(data)
        assert np.array_equal(got[..., 0], vals)  # palette maps index->gray idx
        return
    got = png.decode(data)
    assert np.array_equal(got[..., 0], scaled)


def test_png_decode_interlaced_palette(rng):
    from PIL import Image

    idx = rng.integers(0, 16, (22, 18)).astype(np.uint8)
    im = Image.fromarray(idx, "P")
    pal = [int(x) for x in rng.integers(0, 256, 48)]
    im.putpalette(pal)
    data = _pil_png(im, bits=4, interlace=True)
    got = png.decode(data)
    assert np.array_equal(got[..., :3], np.array(pal, np.uint8).reshape(-1, 3)[idx])


def test_png_loader_falls_back_for_interlaced(tmp_path, rng):
    """imageio.load succeeds on files the native codec rejects."""
    a = rng.integers(0, 256, (16, 16, 4), np.uint8)
    p = str(tmp_path / "il.png")
    with open(p, "wb") as f:
        f.write(_pil_png(a, interlace=True))
    loaded, hdr = imageio.load(p)
    assert not hdr
    np.testing.assert_allclose(loaded, a.astype(np.float32) / 255.0, atol=1e-6)

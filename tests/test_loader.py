"""Native threaded frame loader tests."""

import numpy as np
import pytest

from image_denoising_filter.utils import imageio

native = pytest.importorskip("image_denoising_filter.utils.native")
if not native.available():
    pytest.skip("libidf_native.so not built", allow_module_level=True)


def _write_frames(tmp_path, n, hdr=False):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        img = rng.uniform(0, 1, (24, 32, 4)).astype(np.float32)
        p = str(tmp_path / f"f_{i:04d}.{'exr' if hdr else 'png'}")
        imageio.save(p, img)
        paths.append(p)
    return paths


def test_loader_order_and_content(tmp_path):
    paths = _write_frames(tmp_path, 6)
    loader = native.FrameLoader(paths, lookahead=2, threads=3)
    try:
        for i, frame in enumerate(loader):
            want, _ = imageio.load(paths[i])
            np.testing.assert_array_equal(frame, want)
    finally:
        loader.close()


def test_loader_hdr(tmp_path):
    paths = _write_frames(tmp_path, 3, hdr=True)
    loader = native.FrameLoader(paths)
    try:
        for i in range(3):
            want, _ = imageio.load(paths[i])
            np.testing.assert_array_equal(loader.get(i), want)
    finally:
        loader.close()


def test_loader_duplicate_paths(tmp_path):
    """The frames list legitimately contains the target twice (reference
    loads target first, then all same-ext files incl. itself)."""
    paths = _write_frames(tmp_path, 2)
    dup = [paths[1], paths[0], paths[1]]
    loader = native.FrameLoader(dup)
    try:
        a = loader.get(0)
        c = loader.get(2)
        np.testing.assert_array_equal(a, c)
    finally:
        loader.close()


def test_loader_missing_file(tmp_path):
    loader = native.FrameLoader([str(tmp_path / "nope.png")])
    try:
        with pytest.raises(ValueError):
            loader.get(0)
    finally:
        loader.close()


def test_prefetcher_uses_native(tmp_path):
    from image_denoising_filter.runtime import FramePrefetcher

    paths = _write_frames(tmp_path, 5)
    pf = FramePrefetcher(
        paths, lambda p: imageio.load(p)[0], depth=2, native_paths=True
    )
    assert pf._native is not None
    outs = [np.asarray(x) for x in pf]
    for i, o in enumerate(outs):
        want, _ = imageio.load(paths[i])
        np.testing.assert_array_equal(o, want)


def test_loader_non_monotonic_get_raises(tmp_path):
    paths = _write_frames(tmp_path, 3)
    loader = native.FrameLoader(paths)
    try:
        loader.get(1)
        with pytest.raises(ValueError, match="monotonic"):
            loader.get(0)
        with pytest.raises(ValueError, match="out of range"):
            loader.get(99)
    finally:
        loader.close()

"""Dataset discovery tests (src/main.cpp:1341-1397 semantics)."""

import os

import numpy as np

from image_denoising_filter.utils import dataset, png


def _mk(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    png.write(path, np.zeros((2, 2, 4), np.uint8))


def test_frame_id():
    assert dataset.frame_id("/a/b/Animation01_LDR_0007.png") == "0007"


def test_discover_frames_and_layers(tmp_path):
    root = str(tmp_path / "anim")
    for i in range(12):
        _mk(f"{root}/frame_{i:04d}.png")
    # A different extension must not be picked up as a frame.
    open(f"{root}/notes.txt", "w").write("x")
    # Layer subdir: files whose name contains the target's frame ID.
    _mk(f"{root}/RenderElements/diffuse_0003.png")
    _mk(f"{root}/RenderElements/normal_0003.png")
    _mk(f"{root}/RenderElements/diffuse_0005.png")

    target = f"{root}/frame_0003.png"
    ds = dataset.discover(target, multiframe=True, use_layers=True)
    assert ds.target == target
    assert ds.frames[0] == target  # target always first
    assert len(ds.frames) == 10  # framesToUse cap (src/main.cpp:1341)
    assert all(f.endswith(".png") for f in ds.frames)
    assert len(ds.layers) == 2
    assert all("0003" in os.path.basename(p) for p in ds.layers)
    assert not ds.is_hdr


def test_discover_single_frame(tmp_path):
    root = str(tmp_path / "anim")
    _mk(f"{root}/frame_0000.png")
    _mk(f"{root}/frame_0001.png")
    ds = dataset.discover(f"{root}/frame_0000.png")
    assert ds.frames == (f"{root}/frame_0000.png",)
    assert ds.layers == ()

"""CLI battery smoke test (linear + CPU configs; the Pallas configs are covered
by test_pipeline with small radii -- the CLI uses full reference params, which
are slow to trace in interpret mode)."""

import os

import numpy as np

from image_denoising_filter import cli
from image_denoising_filter.utils import imageio


def test_cli_linear_and_cpu(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (32, 40, 4)).astype(np.float32)
    target = str(tmp_path / "frame_0000.png")
    imageio.save(target, img)

    rc = cli.main([target, "--output-dir", str(tmp_path), "--configs", "linear,cpu1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "linear layout" in out
    assert "transfer time:" in out and "execution time:" in out
    assert "Time taken:" in out
    assert os.path.exists(tmp_path / "output-linear-bialteral.png")
    assert os.path.exists(tmp_path / "output-cpu.png")


def test_cli_bad_input_returns_error(tmp_path, capsys):
    rc = cli.main([str(tmp_path / "missing.png")])
    assert rc == 1
    assert "error:" in capsys.readouterr().err


def test_cli_param_flags(tmp_path, capsys):
    """Filter parameters are CLI-settable (the reference requires editing
    main.cpp, README.md:3). Smaller radius must change the output."""
    import numpy as np

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (24, 32, 4)).astype(np.float32)
    target = str(tmp_path / "frame_0000.png")
    imageio.save(target, img)
    base = ["--output-dir", str(tmp_path), "--configs", "linear"]
    assert cli.main([target, *base, "--radius", "2"]) == 0
    a, _ = imageio.load(tmp_path / "output-linear-bialteral.png")
    assert cli.main([target, *base, "--radius", "6", "--sigma-spatial", "4"]) == 0
    b, _ = imageio.load(tmp_path / "output-linear-bialteral.png")
    assert not np.array_equal(a, b)


def test_cli_all_frames(tmp_path):
    """Serving mode: every frame in the directory gets its own output dir."""
    import numpy as np

    rng = np.random.default_rng(0)
    for i in range(3):
        imageio.save(
            str(tmp_path / f"frame_{i:04d}.png"),
            rng.uniform(0, 1, (24, 32, 4)).astype(np.float32),
        )
    rc = cli.main(
        [
            str(tmp_path / "frame_0000.png"),
            "--output-dir", str(tmp_path / "out"),
            "--configs", "linear",
            "--all-frames",
            "--radius", "2",
        ]
    )
    assert rc == 0
    for i in range(3):
        assert os.path.exists(
            tmp_path / "out" / f"frame_{i:04d}" / "output-linear-bialteral.png"
        )


def test_compare_tool(tmp_path, capsys):
    import sys as _sys

    import numpy as np

    _sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    try:
        import compare
    finally:
        _sys.path.pop(0)
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (16, 16, 4)).astype(np.float32)
    pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    imageio.save(pa, a)
    imageio.save(pb, np.clip(a + 0.01, 0, 1))
    assert compare.main([pa, pb]) == 0
    out = capsys.readouterr().out
    assert "PSNR" in out and "dB" in out
    # mismatched shapes -> error
    imageio.save(pb, a[:8])
    assert compare.main([pa, pb]) == 1


def test_deprecated_import_path():
    """The package's pre-rename directory beside it is an alias: importing
    it warns, and its modules are the very same objects as the package's."""
    import importlib
    import warnings
    from pathlib import Path

    from image_denoising_filter.ops import stencils

    root = Path(__file__).resolve().parent.parent
    (alias,) = [p.name for p in root.glob("image_denoising_filter_*") if (p / "__init__.py").exists()]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        old = importlib.import_module(alias + ".ops.stencils")
    assert old is stencils
    assert importlib.import_module(alias + ".cli") is cli
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)

"""Session with a device mesh: the sharded battery must match the
single-device battery (on the virtual 8-device CPU mesh)."""

import numpy as np
import pytest

from image_denoising_filter.config import (
    BilateralParams,
    LayersParams,
    NlmParams,
    RunConfig,
)
from image_denoising_filter.runtime import Session
from image_denoising_filter.utils import imageio

BP = BilateralParams(radius=3)
LP = LayersParams(radius=3)
NP_ = NlmParams(search_radius=2, patch_radius=1)


def _make_anim(tmp_path, n_frames=4):
    import os

    rng = np.random.default_rng(0)
    root = str(tmp_path / "anim")
    os.makedirs(root + "/RenderElements", exist_ok=True)
    for i in range(n_frames):
        imageio.save(
            f"{root}/frame_{i:04d}.png",
            rng.uniform(0, 1, (48, 64, 4)).astype(np.float32),
        )
    imageio.save(
        f"{root}/RenderElements/albedo_0001.png",
        rng.uniform(0, 1, (48, 64, 4)).astype(np.float32),
    )
    return f"{root}/frame_0001.png"


@pytest.mark.parametrize(
    "cfg",
    [
        RunConfig(),
        RunConfig(use_layers=True),
        RunConfig(nlm=True),
        RunConfig(nlm=True, multiframe=True),
        RunConfig(nlm=True, multiframe=True, overlap=True),
    ],
    ids=["bilateral", "layers", "nlm", "multiframe", "overlap"],
)
def test_sharded_session_matches_single(tmp_path, cfg):
    target = _make_anim(tmp_path)
    kw = dict(
        bilateral_params=BP, layers_params=LP, nlm_params=NP_, output_dir=str(tmp_path)
    )
    single = Session(target, **kw).run(cfg)
    sharded = Session(target, mesh_shape=(2, 4), **kw).run(cfg)
    np.testing.assert_allclose(sharded.image, single.image, rtol=1e-4, atol=1e-5)


def test_sharded_session_odd_rows(tmp_path):
    """47 rows don't divide the 4-way 'y' axis: row padding + crop must be
    invisible."""
    rng = np.random.default_rng(1)
    target = str(tmp_path / "odd_0000.png")
    imageio.save(target, rng.uniform(0, 1, (47, 64, 4)).astype(np.float32))
    kw = dict(bilateral_params=BP, output_dir=str(tmp_path))
    single = Session(target, **kw).run(RunConfig())
    sharded = Session(target, mesh_shape=(1, 4), **kw).run(RunConfig())
    assert sharded.image.shape == (47, 64, 4)
    np.testing.assert_allclose(sharded.image, single.image, rtol=1e-4, atol=1e-5)


def test_sharded_session_turbo(tmp_path):
    """The approximate bilateral-grid mode runs on one device only: with a
    mesh, Session.run_turbo refuses with a clear error (the sharded grid
    paths were removed), and so does the CLI's --turbo with --mesh."""
    from image_denoising_filter import cli

    rng = np.random.default_rng(2)
    target = str(tmp_path / "turbo_0000.png")
    imageio.save(target, rng.uniform(0, 1, (50, 64, 4)).astype(np.float32))
    sess = Session(target, output_dir=str(tmp_path), mesh_shape=(1, 2))
    for cfg in (RunConfig(), RunConfig(use_layers=True)):
        with pytest.raises(ValueError, match="one device"):
            sess.run_turbo(cfg, downsample=2)
    with pytest.raises(SystemExit, match="one device"):
        cli.main([target, "--configs", "bilateral", "--turbo", "2", "--mesh", "1x2"])

"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Asserts the sharded paths are *identical* (up to float tolerance) to the
single-device kernels -- halo exchange must be invisible in the output.
"""

import jax
import numpy as np
import pytest

from image_denoising_filter.config import (
    BilateralParams,
    BorderPolicy,
    LayersParams,
    NlmParams,
)
from image_denoising_filter.ops import reference as ref
from image_denoising_filter.parallel import (
    make_mesh,
    spatial_bilateral,
    spatial_nlm_accumulate,
    temporal_nlm_sharded,
)

BP = BilateralParams(radius=3)
NP_ = NlmParams(search_radius=2, patch_radius=1)


def _frame(seed, h=32, w=32):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (h, w, 4)).astype(np.float32)


def test_eight_devices_available():
    assert len(jax.devices()) == 8, "conftest must provide the virtual mesh"


@pytest.mark.parametrize("n_y", [2, 4, 8])
def test_spatial_bilateral_matches_oracle(n_y):
    mesh = make_mesh((1, n_y))
    img = _frame(0)
    got = np.asarray(spatial_bilateral(img, BP, mesh))
    want = ref.bilateral_reference(img, BP)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_spatial_bilateral_zero_border():
    mesh = make_mesh((1, 4))
    p = BilateralParams(radius=3, border=BorderPolicy.ZERO)
    img = _frame(1)
    got = np.asarray(spatial_bilateral(img, p, mesh))
    want = ref.bilateral_reference(img, p)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_spatial_nlm_matches_oracle():
    mesh = make_mesh((1, 4))
    t, n = _frame(0), _frame(1)
    wc, nw = spatial_nlm_accumulate(t, n, NP_, mesh)
    wwc, wnw = ref.nlm_reference(t, n, NP_)
    np.testing.assert_allclose(np.asarray(wc), wwc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(nw), wnw, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_y", [2, 4])
def test_spatial_bilateral_linear_layout_sharded(n_y):
    """The linear-layout (XLA) variant shards over the same mesh -- a --mesh
    run must not silently fall back to single-device for the linear config."""
    mesh = make_mesh((1, n_y))
    img = _frame(3)
    got = np.asarray(spatial_bilateral(img, BP, mesh, linear=True))
    want = ref.bilateral_reference(img, BP)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_spatial_nlm_linear_layout_sharded():
    mesh = make_mesh((1, 4))
    t, n = _frame(0), _frame(1)
    wc, nw = spatial_nlm_accumulate(t, n, NP_, mesh, linear=True)
    wwc, wnw = ref.nlm_reference(t, n, NP_)
    np.testing.assert_allclose(np.asarray(wc), wwc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(nw), wnw, rtol=1e-4, atol=1e-5)


def test_split_halo_interior_edge_stitching():
    """Shards tall enough for the interior/edge split (rows >= 3*halo) take
    the compute-overlap path; output must still be exactly the oracle's."""
    mesh = make_mesh((1, 2))
    img = _frame(4, h=64, w=32)  # 32 rows/shard, halo 3 -> split path
    got = np.asarray(spatial_bilateral(img, BP, mesh))
    want = ref.bilateral_reference(img, BP)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_session_sharded_temporal_streams_chunks(tmp_path):
    """Session's sharded multiframe path uploads frames in 'frame'-axis-sized
    chunks with the next chunk's transfer in flight; output must match the
    single-device multiframe run (up to chunked-sum reassociation)."""
    import os

    from image_denoising_filter.config import RunConfig
    from image_denoising_filter.runtime.session import Session
    from image_denoising_filter.utils import imageio

    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "anim", exist_ok=True)
    for i in range(7):  # 7 frames over a 2-wide frame axis -> 4 chunks, 1 pad
        imageio.save(str(tmp_path / "anim" / f"f_{i:04d}.png"), _frame(i, h=64, w=32))
    target = str(tmp_path / "anim" / "f_0000.png")
    cfg = RunConfig(nlm=True, multiframe=True)
    single = Session(target, nlm_params=NP_, output_dir=str(tmp_path)).run(cfg)
    sharded = Session(
        target, nlm_params=NP_, output_dir=str(tmp_path), mesh_shape=(2, 4)
    ).run(cfg)
    np.testing.assert_allclose(sharded.image, single.image, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (1, 8), (8, 1)])
def test_temporal_nlm_sharded_full(mesh_shape):
    """Frame-DP x spatial sharding: psum of weight partials over 'frame' must
    equal the sequential frame loop + normalize."""
    mesh = make_mesh(mesh_shape)
    target = _frame(0)
    n_frames = 8
    frames = np.stack([_frame(10 + i) for i in range(n_frames)])
    got = np.asarray(temporal_nlm_sharded(target, frames, NP_, mesh=mesh))

    wc = np.zeros(target.shape, np.float32)
    nw = np.zeros(target.shape[:2], np.float32)
    for f in frames:
        pwc, pnw = ref.nlm_reference(target, f, NP_)
        wc += pwc
        nw += pnw
    want = ref.normalize_reference(wc, nw)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_temporal_nlm_sharded_valid_mask():
    """Padding frames (valid=0) contribute neither weights nor norm seed in
    the frame-batched sharded path: a 5-frame run padded to 8 must equal the
    unpadded 5-frame sequential loop."""
    import jax.numpy as jnp

    mesh = make_mesh((4, 2))
    target = _frame(0)
    real = [_frame(20 + i) for i in range(5)]
    frames = np.stack(real + [np.zeros_like(real[0])] * 3)
    valid = jnp.asarray([1.0] * 5 + [0.0] * 3)
    got = np.asarray(
        temporal_nlm_sharded(target, frames, NP_, mesh=mesh, valid=valid)
    )

    wc = np.zeros(target.shape, np.float32)
    nw = np.zeros(target.shape[:2], np.float32)
    for f in real:
        pwc, pnw = ref.nlm_reference(target, f, NP_)
        wc += pwc
        nw += pnw
    want = ref.normalize_reference(wc, nw)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


def test_spatial_nlm_turbo_params_sharded():
    """The turbo NLM settings (stride-2 search) shard like the exact kernel:
    row-sharded output must match the single-device kernel with identical
    params."""
    from image_denoising_filter.ops import nlm_accumulate

    mesh = make_mesh((1, 4))
    t, n = _frame(0), _frame(1)
    params = NlmParams(search_radius=2, patch_radius=1, search_stride=2)
    wc, nw = spatial_nlm_accumulate(t, n, params, mesh)
    wwc, wnw = nlm_accumulate(t, n, params)
    np.testing.assert_allclose(np.asarray(wc), np.asarray(wwc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(nw), np.asarray(wnw), rtol=1e-5, atol=1e-6)


def test_spatial_nlm_weights_halfres_sharded():
    """weights_halfres shards row-identically to single-device when the
    per-shard row count and the halo (s + p) are both EVEN -- every shard's
    local block then starts on the absolute even-row pooling lattice. The
    reference NLM params (s=7, p=3: halo 10) satisfy this for any even
    per-shard height (4K: 2160/8 = 270). Odd offsets would shift the lattice
    by one row (still a valid approximation, not bitwise-equal;
    parallel.spatial._check_hrw_lattice refuses them)."""
    from image_denoising_filter.ops import nlm_accumulate

    mesh = make_mesh((1, 4))
    t, n = _frame(0, h=64), _frame(1, h=64)  # 16 rows/shard (even)
    params = NlmParams(search_stride=2, weights_halfres=True)  # s=7, p=3
    wc, nw = spatial_nlm_accumulate(t, n, params, mesh)
    wwc, wnw = nlm_accumulate(t, n, params)
    np.testing.assert_allclose(np.asarray(wc), np.asarray(wwc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(nw), np.asarray(wnw), rtol=1e-5, atol=1e-6)


def test_spatial_nlm_weights_halfres_odd_offset_refused():
    """Odd per-shard rows (or an odd s+p halo) would silently SHIFT the
    half-row pooling lattice per shard (a different, untested approximation
    vs single-device) -- the sharded entry points must refuse instead
    (guard: parallel.spatial._check_hrw_lattice)."""
    from image_denoising_filter.parallel import temporal_nlm_sharded

    mesh = make_mesh((1, 4))
    # 68 rows / 4 shards = 17 rows/shard: divisible but ODD.
    t, n = _frame(0, h=68), _frame(1, h=68)
    params = NlmParams(search_stride=2, weights_halfres=True)  # halo 10 even
    with pytest.raises(ValueError, match="even-row pooling lattice"):
        spatial_nlm_accumulate(t, n, params, mesh)
    # Odd halo: s=6, p=3 -> s+p = 9; even 16 rows/shard doesn't save it.
    t64, n64 = _frame(0, h=64), _frame(1, h=64)
    params_odd_halo = NlmParams(
        search_radius=6, search_stride=2, weights_halfres=True
    )
    with pytest.raises(ValueError, match="even-row pooling lattice"):
        spatial_nlm_accumulate(t64, n64, params_odd_halo, mesh)
    # The temporal (frame-DP x row) path shares the guard.
    frames = np.stack([np.asarray(n), np.asarray(n)])
    with pytest.raises(ValueError, match="even-row pooling lattice"):
        temporal_nlm_sharded(
            np.asarray(t), frames, params, mesh=make_mesh((2, 4))
        )
    # Single-'y'-shard meshes have no lattice offset: no refusal.
    wc, _nw = spatial_nlm_accumulate(t, n, params, make_mesh((1, 1)))
    assert np.isfinite(np.asarray(wc)).all()

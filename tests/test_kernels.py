"""GPU-kernel and XLA tests vs the NumPy oracles.

The Pallas kernels run in interpret mode on the CPU backend (conftest forces
JAX_PLATFORMS=cpu); the same code compiles through Triton for the card
(exercised by chip_smoke.py and the `gpu`-marked tests). Interpret mode
executes op-by-op, so these tests use small images and radii -- the kernel
math is radius-agnostic.
"""

import numpy as np
import pytest

from image_denoising_filter.config import (
    BilateralParams,
    BorderPolicy,
    LayersParams,
    NlmParams,
    TilingConfig,
)
from image_denoising_filter.ops import (
    bilateral,
    bilateral_xla,
    cross_bilateral_layers,
    cross_bilateral_layers_xla,
    nlm_accumulate,
    nlm_xla,
    normalize,
)
from image_denoising_filter.ops import reference as ref

BP = BilateralParams(radius=3)
NP_ = NlmParams(search_radius=2, patch_radius=1)
LP = LayersParams(radius=3)


def _image(rng, h=24, w=32):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [
            0.5 + 0.4 * np.sin(xx / 5.0),
            0.5 + 0.4 * np.cos(yy / 4.0),
            np.where(xx > w / 2, 0.8, 0.2).astype(np.float32),
            np.ones((h, w), np.float32),
        ],
        axis=-1,
    )
    return np.clip(base + rng.normal(0, 0.05, base.shape), 0, 1).astype(np.float32)


@pytest.fixture
def img(rng):
    return _image(rng)


@pytest.fixture
def img2(rng):
    return _image(np.random.default_rng(99))


@pytest.mark.parametrize("impl", [bilateral, bilateral_xla])
def test_bilateral_matches_oracle(img, impl):
    got = np.asarray(impl(img, BP))
    want = ref.bilateral_reference(img, BP)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_bilateral_zero_border(img):
    p = BilateralParams(radius=3, border=BorderPolicy.ZERO)
    got = np.asarray(bilateral(img, p))
    want = ref.bilateral_reference(img, p)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_bilateral_blue_bug(img):
    p = BilateralParams(radius=3, blue_bug=True)
    got = np.asarray(bilateral(img, p))
    want = ref.bilateral_reference(img, p)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_bilateral_tiling_and_partial_tiles(rng):
    """Halo tiling property: tile size must not change the result, including
    partial edge tiles (29 rows with 8/16-row tiles)."""
    img = _image(rng, h=29, w=32)
    want = ref.bilateral_reference(img, BP)
    for th in (8, 16, 32):
        got = np.asarray(bilateral(img, BP, TilingConfig(tile_h=th, tile_w=128)))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f"tile_h={th}")


@pytest.mark.parametrize("impl", [cross_bilateral_layers, cross_bilateral_layers_xla])
def test_layers_matches_oracle(img, img2, impl):
    wc, nw = impl(img, img2, LP)
    wwc, wnw = ref.cross_bilateral_layers_reference(img, img2, LP)
    np.testing.assert_allclose(np.asarray(wc), wwc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(nw), wnw, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", [nlm_accumulate, nlm_xla])
def test_nlm_matches_oracle(img, img2, impl):
    wc, nw = impl(img, img2, NP_)
    wwc, wnw = ref.nlm_reference(img, img2, NP_)
    np.testing.assert_allclose(np.asarray(wc), wwc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(nw), wnw, rtol=1e-4, atol=1e-5)


def test_nlm_full_reference_params_xla(img, img2):
    """Full reference NLM params (s=7, p=3, h=0.5) -- XLA path (the kernel
    with full params is covered on the card by chip_smoke.py)."""
    p = NlmParams()
    wc, nw = nlm_xla(img, img2, p)
    wwc, wnw = ref.nlm_reference(img, img2, p)
    np.testing.assert_allclose(np.asarray(wc), wwc, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(nw), wnw, rtol=2e-4, atol=1e-4)


def test_bilateral_full_reference_params_circle_mask(img):
    """Full GPU reference params (radius 20, sigma_s 2.0): the kernel's
    circular spatial-weight truncation (465 of 1681 taps) stays within the
    documented truncation tolerance of the full-window oracle."""
    p = BilateralParams()  # radius=20, truncate_eps=1e-8 -> disk mask
    got = np.asarray(bilateral(img, p))
    want = ref.bilateral_reference(img, p)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_nlm_batched_frames_matches_per_frame_sum(img, img2, rng):
    """nlm_accumulate_frames (one launch, frame loop inside each program) ==
    the sum of per-frame partials, each frame contributing its norm seed."""
    from image_denoising_filter.ops import nlm_accumulate_frames

    img3 = _image(np.random.default_rng(7))
    frames = np.stack([img, img2, img3])
    wc, nw = nlm_accumulate_frames(img, frames, NP_)
    wwc = np.zeros_like(np.asarray(wc))
    wnw = np.zeros_like(np.asarray(nw))
    for fr in frames:
        pwc, pnw = ref.nlm_reference(img, fr, NP_)
        wwc += pwc
        wnw += pnw
    np.testing.assert_allclose(np.asarray(wc), wwc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(nw), wnw, rtol=1e-4, atol=1e-5)


def test_nlm_batched_frames_tiled_grid(img, img2):
    """Frame batching composes with multi-block grids (each program keeps its
    accumulators while its frame loop advances)."""
    from image_denoising_filter.ops import nlm_accumulate_frames

    frames = np.stack([img2, img])
    tiling = TilingConfig(tile_h=8, tile_w=128)
    wc, nw = nlm_accumulate_frames(img, frames, NP_, tiling)
    awc, anw = ref.nlm_reference(img, img2, NP_)
    bwc, bnw = ref.nlm_reference(img, img, NP_)
    np.testing.assert_allclose(np.asarray(wc), awc + bwc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(nw), anw + bnw, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", [nlm_accumulate, nlm_xla])
@pytest.mark.parametrize(
    "s,p",
    [(2, 1), (6, 3)],  # (6, 3): the bench's trimmed-search gated turbo row
)
def test_nlm_search_stride_matches_strided_oracle(img, img2, impl, s, p):
    """search_stride=2 (the approximate NLM mode) evaluates exactly the strided
    offset subset -- kernel and oracle agree on the reduced candidate set."""
    params = NlmParams(search_radius=s, patch_radius=p, search_stride=2)
    wc, nw = impl(img, img2, params)
    wwc, wnw = ref.nlm_reference(img, img2, params)
    np.testing.assert_allclose(np.asarray(wc), wwc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(nw), wnw, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", [nlm_accumulate, nlm_xla])
@pytest.mark.parametrize(
    "s,p,st",
    [
        (7, 3, 2),  # the bench disk row: 37 of 196 candidates
        (5, 2, 2),  # asymmetric half-open rows through the segmented loops
        (4, 2, 1),  # disk without stride (147-of-196 analog at small s)
    ],
)
def test_nlm_search_disk_matches_disk_oracle(img, img2, impl, s, p, st):
    """search_disk trims candidates to dy^2+dx^2 <= s^2 -- kernel (candidate
    list walked in-kernel) and oracle agree on the reduced candidate set,
    composed with and without search_stride."""
    params = NlmParams(
        search_radius=s, patch_radius=p, search_stride=st, search_disk=True
    )
    wc, nw = impl(img, img2, params)
    wwc, wnw = ref.nlm_reference(img, img2, params)
    np.testing.assert_allclose(np.asarray(wc), wwc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(nw), wnw, rtol=1e-4, atol=1e-5)
    # The trim is live: it must differ from the untrimmed subset.
    base = NlmParams(search_radius=s, patch_radius=p, search_stride=st)
    wc_b, _ = impl(img, img2, base)
    assert not np.array_equal(np.asarray(wc), np.asarray(wc_b))


@pytest.mark.parametrize("impl", [nlm_accumulate, nlm_xla])
def test_nlm_weights_halfres_validation(img, img2, impl):
    """weights_halfres is only defined on the stride-2 / p=3 lattice (even dy
    offsets, 3-row half window == the 6-row full box); the tiled entry point
    routes it to the XLA lowering, and both reject anything else."""
    with pytest.raises(ValueError):
        impl(img, img2, NlmParams(search_stride=1, weights_halfres=True))
    with pytest.raises(ValueError):
        impl(
            img,
            img2,
            NlmParams(search_stride=2, patch_radius=2, weights_halfres=True),
        )


def test_nlm_identical_frames_peak_weight(img):
    """NLM of a frame against itself: the zero-offset candidate has SSD 0 =>
    weight exactly 1 at every pixel, so norm >= 1 + seed."""
    _, nw = nlm_xla(img, img, NP_)
    assert np.all(np.asarray(nw) >= 1.0 + NP_.norm_seed - 1e-6)


def test_normalize_matches_oracle(rng):
    wc = rng.uniform(0, 5, (24, 32, 4)).astype(np.float32)
    nw = rng.uniform(0.5, 3, (24, 32)).astype(np.float32)
    nw[3, 5] = 0.0  # sentinel pixel
    got = np.asarray(normalize(wc, nw))
    want = ref.normalize_reference(wc, nw)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got[3, 5], [1.0, 0.0, 1.0, 1.0])


def test_two_pass_equals_fused(img):
    """layers partials + normalize == bilateral with guide==image: with
    layer == target the cross-bilateral degenerates to the plain bilateral."""
    wc, nw = cross_bilateral_layers_xla(img, img, LP)
    two_pass = np.asarray(normalize(wc, nw))
    fused = np.asarray(bilateral_xla(img, BP))
    np.testing.assert_allclose(two_pass, fused, rtol=1e-4, atol=1e-5)


def test_pallas_vs_xla_agree(img):
    """The tiled (GPU kernel) and linear (XLA) layout variants must agree, like the
    reference's bialteral.comp vs bialteral_linear.comp."""
    a = np.asarray(bilateral(img, BP))
    b = np.asarray(bilateral_xla(img, BP))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_nlm_zero_border(img, img2):
    p = NlmParams(search_radius=2, patch_radius=1, border=BorderPolicy.ZERO)
    wc, nw = nlm_accumulate(img, img2, p)
    wwc, wnw = ref.nlm_reference(img, img2, p)
    np.testing.assert_allclose(np.asarray(wc), wwc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(nw), wnw, rtol=1e-4, atol=1e-5)


def test_layers_blue_bug(img, img2):
    p = LayersParams(radius=3, blue_bug=True)
    wc, nw = cross_bilateral_layers(img, img2, p)
    wwc, wnw = ref.cross_bilateral_layers_reference(img, img2, p)
    np.testing.assert_allclose(np.asarray(wc), wwc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(nw), wnw, rtol=1e-4, atol=1e-5)


def test_bilateral_xla_differentiable(img):
    """The XLA variant is differentiable end-to-end (denoiser-in-the-loop
    training use case)."""
    import jax
    import jax.numpy as jnp

    def loss(x):
        return jnp.sum(bilateral_xla(x, BP) ** 2)

    g = jax.grad(loss)(jnp.asarray(img))
    assert g.shape == img.shape
    assert bool(jnp.isfinite(g).all()) and float(jnp.abs(g).max()) > 0


def test_bilateral_window_larger_than_image(rng):
    """Stencil window larger than the image: clamp padding + partial tiles
    must still match the oracle (8x16 image, radius 6 => 13x13 window)."""
    img = rng.uniform(0, 1, (8, 16, 4)).astype(np.float32)
    p = BilateralParams(radius=6, sigma_spatial=10.0)
    got = np.asarray(bilateral(img, p))
    want = ref.bilateral_reference(img, p)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", [bilateral, bilateral_xla])
def test_bilateral_uniform_alpha_exact(img, impl):
    """The uniform-alpha fast path must match the full kernel exactly when
    alpha is one constant (sum(w*a) == a*sum(w))."""
    img = img.copy()
    img[..., 3] = 0.625
    full = np.asarray(impl(img, BP))
    fast = np.asarray(impl(img, BilateralParams(radius=3, uniform_alpha=True)))
    np.testing.assert_allclose(fast, full, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", [nlm_accumulate, nlm_xla])
def test_nlm_uniform_alpha_exact(img, img2, impl):
    img2 = img2.copy()
    img2[..., 3] = 1.0
    wc_full, nw_full = impl(img, img2, NP_)
    p = NlmParams(search_radius=2, patch_radius=1, uniform_alpha=True)
    wc_fast, nw_fast = impl(img, img2, p)
    np.testing.assert_allclose(np.asarray(wc_fast), np.asarray(wc_full), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(nw_fast), np.asarray(nw_full), rtol=1e-6)


# ---------------------------------------------------------------------------
# The GPU kernels' wrappers: shapes that are not block multiples, borders,
# candidate lists, the frame mask, block choice and the dispatch rule.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("border", [BorderPolicy.CLAMP, BorderPolicy.ZERO])
@pytest.mark.parametrize("hw", [(13, 37), (29, 70), (17, 130)])
def test_bilateral_ragged_shapes_match_oracle(rng, hw, border):
    """Neither side a multiple of the (16, 64) block: padded inputs, whole-
    block outputs and the crop must give the oracle's image exactly."""
    x = _image(rng, *hw)
    p = BilateralParams(radius=3, border=border)
    got = np.asarray(bilateral(x, p))
    np.testing.assert_allclose(got, ref.bilateral_reference(x, p), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("uniform_alpha", [False, True])
@pytest.mark.parametrize("border", [BorderPolicy.CLAMP, BorderPolicy.ZERO])
def test_layers_guided_ragged_matches_oracle(rng, border, uniform_alpha):
    """The guided form of the bilateral kernel (weights from the layer, colors
    from the target) on a ragged shape, both borders, with and without the
    uniform-alpha shortcut (alpha constant: the shortcut is exact)."""
    t = _image(rng, 19, 45)
    layer = _image(np.random.default_rng(5), 19, 45)
    t[..., 3] = 0.75
    p = LayersParams(radius=3, border=border, uniform_alpha=uniform_alpha)
    want_p = LayersParams(radius=3, border=border)
    wc, nw = cross_bilateral_layers(t, layer, p)
    wwc, wnw = ref.cross_bilateral_layers_reference(t, layer, want_p)
    if uniform_alpha and border == BorderPolicy.ZERO:
        # ZERO padding injects alpha-0 taps: the shortcut is only exact on
        # the colour channels and the norm there (Session never enables it).
        wc, wwc = np.asarray(wc)[..., :3], wwc[..., :3]
    np.testing.assert_allclose(np.asarray(wc), wwc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(nw), wnw, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("border", [BorderPolicy.CLAMP, BorderPolicy.ZERO])
@pytest.mark.parametrize(
    "s,p,st,disk", [(3, 1, 1, False), (3, 2, 2, False), (4, 1, 1, True), (5, 2, 2, True)]
)
def test_nlm_ragged_candidates_match_oracle(rng, s, p, st, disk, border):
    """The NLM kernel on a shape that is not a block multiple, over stride
    and disk candidate lists and both borders."""
    x = _image(rng, 21, 67)
    y = _image(np.random.default_rng(3), 21, 67)
    params = NlmParams(
        search_radius=s, patch_radius=p, search_stride=st, search_disk=disk,
        border=border,
    )
    wc, nw = nlm_accumulate(x, y, params)
    wwc, wnw = ref.nlm_reference(x, y, params)
    np.testing.assert_allclose(np.asarray(wc), wwc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(nw), wnw, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("uniform_alpha", [False, True])
def test_nlm_frames_valid_mask(img, img2, uniform_alpha):
    """A masked frame contributes neither weights nor its norm seed: frames
    [a, b, c] with valid [1, 0, 1] == partials of a + c. With uniform alpha
    each frame's own constant alpha is reconstructed in-kernel."""
    from image_denoising_filter.ops import nlm_accumulate_frames

    img3 = _image(np.random.default_rng(7))
    frames = np.stack([img, img2, img3])
    frames[..., 3] = np.array([1.0, 0.5, 0.25], np.float32)[:, None, None]
    p = NlmParams(search_radius=2, patch_radius=1, uniform_alpha=uniform_alpha)
    valid = np.array([1.0, 0.0, 1.0], np.float32)
    wc, nw = nlm_accumulate_frames(img, frames, p, None, valid)
    base = NlmParams(search_radius=2, patch_radius=1)
    awc, anw = ref.nlm_reference(img, frames[0], base)
    cwc, cnw = ref.nlm_reference(img, frames[2], base)
    np.testing.assert_allclose(np.asarray(wc), awc + cwc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(nw), anw + cnw, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "s,st,disk,count",
    [(7, 1, False, 196), (7, 2, False, 49), (7, 2, True, 37), (6, 2, False, 36), (3, 1, True, 27)],
)
def test_nlm_candidate_lists(s, st, disk, count):
    """The candidate list the kernel walks: the half-open [-s, s) grid,
    strided with the zero offset kept, optionally trimmed to the disk --
    the same subset ops/xla.py:nlm_xla evaluates."""
    from image_denoising_filter.ops.stencils import nlm_candidates

    dy, dx, bias = nlm_candidates(
        NlmParams(search_radius=s, search_stride=st, search_disk=disk)
    )
    assert len(dy) == len(dx) == len(bias) == count
    assert dy.min() >= -s and dy.max() < s and dx.min() >= -s and dx.max() < s
    self_idx = np.flatnonzero((dy == 0) & (dx == 0))
    assert len(self_idx) == 1
    if disk:
        assert np.all(dy * dy + dx * dx <= s * s)


@pytest.mark.parametrize("st", [1, 2, 3])
def test_nlm_candidate_bias(st):
    """Importance compensation: every non-self offset weighs stride^2 (log2
    bias), the self-match weighs 1; the exact search has no bias at all."""
    from image_denoising_filter.ops.stencils import nlm_candidates

    dy, dx, bias = nlm_candidates(NlmParams(search_radius=4, search_stride=st))
    is_self = (dy == 0) & (dx == 0)
    assert np.all(bias[is_self] == 0.0)
    want = 0.0 if st == 1 else np.log2(st * st)
    np.testing.assert_allclose(bias[~is_self], want)


@pytest.mark.parametrize(
    "backend,want", [("cpu", True), ("gpu", False), ("rocm", None), ("metal", None)]
)
def test_dispatch_rule(monkeypatch, backend, want):
    """cpu runs the kernels in interpret mode, gpu compiles them for the
    card, and any other backend raises and names itself -- no fallback."""
    import jax

    from image_denoising_filter.ops import stencils

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if want is None:
        with pytest.raises(RuntimeError, match=backend):
            stencils.interpret_mode()
    else:
        assert stencils.interpret_mode() is want


def test_block_choice():
    """Blocks are powers of two, shrink to small images, and honour the
    TilingConfig override; a non-power-of-two block is refused."""
    from image_denoising_filter.ops.stencils import BLOCK, _block

    assert _block(1080, 1920, None) == BLOCK == (16, 64)
    assert _block(5, 20, None) == (8, 32)
    assert _block(100, 100, TilingConfig(tile_h=32)) == (32, 64)
    with pytest.raises(ValueError):
        _block(100, 100, TilingConfig(tile_w=48))


@pytest.mark.parametrize(
    "tiling",
    [TilingConfig(tile_h=8, tile_w=32), TilingConfig(tile_h=32, tile_w=16), TilingConfig(tile_h=4, tile_w=128)],
)
def test_block_size_does_not_change_results(img, img2, tiling):
    """Block size is a schedule, not math: bilateral and NLM agree with the
    default blocks for every block shape."""
    np.testing.assert_allclose(
        np.asarray(bilateral(img, BP, tiling)), np.asarray(bilateral(img, BP)),
        rtol=1e-6, atol=1e-7,
    )
    a = nlm_accumulate(img, img2, NP_, tiling)
    b = nlm_accumulate(img, img2, NP_)
    np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]), rtol=1e-6, atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["bilateral", "layers", "nlm", "nlm_frames"])
def test_kernels_match_xla_on_the_card(gpu_backend, family):
    """On the card: each compiled kernel vs its XLA counterpart at a
    1080p-sized shape (rtol 1e-4 / atol 1e-5: exp2 folding and a different
    summation order)."""
    import jax.numpy as jnp

    from image_denoising_filter.ops import nlm_accumulate_frames

    rng = np.random.default_rng(0)
    x = _image(rng, 1080, 1920)
    y = _image(np.random.default_rng(1), 1080, 1920)
    if family == "bilateral":
        got, want = [bilateral(x, BilateralParams())], [bilateral_xla(x, BilateralParams())]
    elif family == "layers":
        got = cross_bilateral_layers(x, y, LayersParams())
        want = cross_bilateral_layers_xla(x, y, LayersParams())
    elif family == "nlm":
        got, want = nlm_accumulate(x, y, NlmParams()), nlm_xla(x, y, NlmParams())
    else:
        frames = jnp.stack([x, y, x])
        got = nlm_accumulate_frames(x, frames, NlmParams())
        parts = [nlm_xla(x, f, NlmParams()) for f in (x, y, x)]
        want = [sum(p[i] for p in parts) for i in range(2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-4, atol=1e-5)

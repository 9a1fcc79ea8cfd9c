"""Approximate turbo bilateral (per-channel bilateral grid) quality gates."""

import numpy as np
import pytest

from image_denoising_filter.config import BilateralParams
from image_denoising_filter.ops import bilateral_fast
from image_denoising_filter.ops import reference as ref


def _scene(rng, h=96, w=128, noise=0.06):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    clean = np.stack(
        [
            0.5 + 0.35 * np.sin(xx / 25),
            0.45 + 0.35 * np.cos(yy / 20),
            np.where((xx // 48 + yy // 32) % 2 == 0, 0.75, 0.25).astype(np.float32),
            np.ones((h, w), np.float32),
        ],
        -1,
    )
    noisy = np.clip(
        clean + rng.normal(0, noise, clean.shape) * [1, 1, 1, 0], 0, 1
    ).astype(np.float32)
    return clean, noisy


@pytest.mark.parametrize("downsample,min_db", [(1, 45.0), (2, 40.0), (4, 35.0)])
def test_turbo_close_to_exact(rng, downsample, min_db):
    clean, noisy = _scene(rng)
    bp = BilateralParams()
    exact = ref.bilateral_reference(noisy, bp)
    got = np.asarray(bilateral_fast(noisy, bp, 8, downsample))
    db = ref.psnr(got[..., :3], exact[..., :3])
    assert db >= min_db, f"turbo d={downsample}: {db:.1f} dB < {min_db}"


def test_turbo_denoises_as_well_as_exact(rng):
    """The per-channel grid should denoise within ~1 dB of the exact kernel on
    noisy natural-image content (it slightly beats it on chroma noise)."""
    clean, noisy = _scene(rng)
    bp = BilateralParams()
    exact = ref.bilateral_reference(noisy, bp)
    got = np.asarray(bilateral_fast(noisy, bp, 8, 2))
    db_exact = ref.psnr(exact[..., :3], clean[..., :3])
    db_fast = ref.psnr(got[..., :3], clean[..., :3])
    assert db_fast >= db_exact - 1.0


def test_turbo_constant_alpha_preserved(rng):
    _, noisy = _scene(rng)
    noisy[..., 3] = 0.5
    got = np.asarray(bilateral_fast(noisy, BilateralParams(), 8, 2))
    np.testing.assert_allclose(got[..., 3], 0.5, atol=1e-4)


def test_nlm_stride2_close_to_exact(rng):
    """The approximate NLM (stride-2 search, 49 of 196 candidates) must track
    the exact NLM output closely on noisy structured content."""
    from image_denoising_filter.config import NlmParams
    from image_denoising_filter.ops import nlm_xla, normalize

    clean, noisy = _scene(rng)
    exact = np.asarray(normalize(*nlm_xla(noisy, noisy, NlmParams())))
    fast = np.asarray(
        normalize(*nlm_xla(noisy, noisy, NlmParams(search_stride=2)))
    )
    db = ref.psnr(fast[..., :3], exact[..., :3])
    assert db >= 40.0, f"stride-2 NLM vs exact: {db:.1f} dB"


def test_nlm_s6_stride2_gate(rng):
    """The trimmed-search NLM turbo row (s=6, stride 2: 36 of 196 candidates)
    must stay above the 40 dB gate vs the exact s=7 output (s=5 and stride 3
    fail the gate in a CPU quality screen)."""
    from image_denoising_filter.config import NlmParams
    from image_denoising_filter.ops import nlm_xla, normalize

    clean, noisy = _scene(rng)
    exact = np.asarray(normalize(*nlm_xla(noisy, noisy, NlmParams())))
    fast = np.asarray(
        normalize(
            *nlm_xla(noisy, noisy, NlmParams(search_radius=6, search_stride=2))
        )
    )
    db = ref.psnr(fast[..., :3], exact[..., :3])
    assert db >= 40.0, f"s=6 stride-2 NLM vs exact: {db:.1f} dB"


@pytest.mark.parametrize("s_r,st", [(7, 2), (6, 2)])
def test_nlm_turbo_kernel_path_gate(rng, s_r, st):
    """The turbo NLM rows ship through the STRIDED GPU kernel
    (nlm_accumulate), not the XLA variant the gates above exercise -- gate
    that path (interpret mode on CPU) so a strided-kernel-specific quality
    bug cannot pass every test."""
    from image_denoising_filter.config import NlmParams
    from image_denoising_filter.ops import nlm_accumulate, normalize

    clean, noisy = _scene(rng)
    exact = np.asarray(
        normalize(*nlm_accumulate(noisy, noisy, NlmParams(uniform_alpha=True)))
    )
    fast = np.asarray(
        normalize(
            *nlm_accumulate(
                noisy,
                noisy,
                NlmParams(
                    uniform_alpha=True, search_radius=s_r, search_stride=st
                ),
            )
        )
    )
    db = ref.psnr(fast[..., :3], exact[..., :3])
    assert db >= 40.0, f"s={s_r} stride-{st} kernel NLM vs exact: {db:.1f} dB"


@pytest.mark.parametrize("disk,min_db", [(False, 42.0), (True, 41.0)])
def test_nlm_weights_halfres_gate(disk, min_db):
    """Half-res-weights NLM (weights_halfres, an XLA path) on the sinusoid
    gate content (256x512). A CPU screen measured 42.5 / 41.5 dB (disk) --
    thresholds sit 0.5 dB under. NOTE the approximation is
    content-dependent: hard ROW edges (the 96x128 checker scene above) drop
    it to ~35 dB."""
    from image_denoising_filter.config import NlmParams
    from image_denoising_filter.ops import nlm_accumulate, normalize

    r = np.random.default_rng(0)
    yy, xx = np.mgrid[0:256, 0:512].astype(np.float32)
    clean = np.stack(
        [
            0.5 + 0.4 * np.sin(xx / 37.0) * np.cos(yy / 23.0),
            0.5 + 0.4 * np.cos(xx / 53.0 + yy / 31.0),
            0.5 + 0.3 * np.sin((xx + yy) / 41.0),
            np.ones_like(xx),
        ],
        axis=-1,
    ).astype(np.float32)
    nz = (clean + r.normal(0, 0.05, clean.shape)).astype(np.float32)
    nz[..., 3] = 1.0
    nz2 = (clean + r.normal(0, 0.05, clean.shape)).astype(np.float32)
    nz2[..., 3] = 1.0
    exact = np.asarray(
        normalize(*nlm_accumulate(nz, nz2, NlmParams(uniform_alpha=True)))
    )
    fast = np.asarray(
        normalize(
            *nlm_accumulate(
                nz,
                nz2,
                NlmParams(
                    uniform_alpha=True,
                    search_stride=2,
                    search_disk=disk,
                    weights_halfres=True,
                ),
            )
        )
    )
    db = ref.psnr(fast[..., :3], exact[..., :3])
    assert db >= min_db, f"hrw disk={disk}: {db:.1f} dB < {min_db}"


def test_nlm_stride2_denoises_as_well_as_exact(rng):
    from image_denoising_filter.config import NlmParams
    from image_denoising_filter.ops import nlm_xla, normalize

    clean, noisy = _scene(rng)
    exact = np.asarray(normalize(*nlm_xla(noisy, noisy, NlmParams())))
    fast = np.asarray(
        normalize(*nlm_xla(noisy, noisy, NlmParams(search_stride=2)))
    )
    db_exact = ref.psnr(exact[..., :3], clean[..., :3])
    db_fast = ref.psnr(fast[..., :3], clean[..., :3])
    assert db_fast >= db_exact - 0.5, f"{db_fast:.1f} vs exact {db_exact:.1f}"


def test_ssim_metric_sanity(rng):
    a = rng.uniform(0, 1, (48, 64, 3))
    assert ref.ssim(a, a) == pytest.approx(1.0)
    noisy = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1)
    v = ref.ssim(a, noisy)
    assert 0.5 < v < 1.0
    assert ref.ssim(a, np.full_like(a, a.mean())) < 0.1


def test_turbo_session_and_cli(tmp_path):
    from image_denoising_filter import cli
    from image_denoising_filter.utils import imageio

    rng = np.random.default_rng(0)
    _, noisy = _scene(rng, h=48, w=64)
    target = str(tmp_path / "f_0000.png")
    imageio.save(target, noisy)
    rc = cli.main(
        [target, "--output-dir", str(tmp_path), "--configs", "bilateral", "--turbo", "2"]
    )
    assert rc == 0
    import os

    assert os.path.exists(tmp_path / "output-nonlinear-bialteral.png")


# ---- TURBO layers (guided grid) --------------------------------------------


def _exact_layers(noisy, layers, lp):
    from image_denoising_filter.ops import reference as r

    wc = np.zeros(noisy.shape, np.float32)
    nw = np.zeros(noisy.shape[:2], np.float32)
    for layer in layers:
        pwc, pnw = r.cross_bilateral_layers_reference(noisy, layer, lp)
        wc += pwc
        nw += pnw
    return r.normalize_reference(wc, nw)


def test_turbo_layers_close_to_exact(rng):
    from image_denoising_filter.config import LayersParams
    from image_denoising_filter.ops import (
        cross_bilateral_layers_fast,
        normalize_layers_fast,
    )

    clean, noisy = _scene(rng)
    # Two guide layers: the clean scene and a gradient plane (G-buffer-ish).
    h, w = clean.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    grad = np.stack(
        [xx / w, yy / h, (xx + yy) / (h + w), np.ones((h, w), np.float32)], -1
    ).astype(np.float32)
    layers = [clean, grad]
    # radius 6 keeps the brute-force oracle tractable; sigma_s is the
    # reference value so the grid's blur approximation is exercised as-is.
    lp = LayersParams(radius=6)

    want = _exact_layers(noisy, layers, lp)
    wc = np.zeros((h, w, 4), np.float32)
    nw = np.zeros((h, w, 3), np.float32)
    for layer in layers:
        pwc, pnw = cross_bilateral_layers_fast(noisy, layer, lp, 8, 2)
        wc += np.asarray(pwc)
        nw += np.asarray(pnw)
    got = np.asarray(normalize_layers_fast(wc, nw))
    db = ref.psnr(got[..., :3], want[..., :3])
    assert db >= 35.0, f"turbo layers vs exact: {db:.1f} dB"


def test_turbo_layers_no_layers_sentinel(rng):
    from image_denoising_filter.ops import normalize_layers_fast

    out = np.asarray(
        normalize_layers_fast(
            np.zeros((8, 16, 4), np.float32), np.zeros((8, 16, 3), np.float32)
        )
    )
    np.testing.assert_allclose(out, np.broadcast_to([1, 0, 1, 1], out.shape))


def test_turbo_layers_session_and_cli(tmp_path):
    import os
    import subprocess
    import sys

    from image_denoising_filter.utils import imageio

    rng = np.random.default_rng(3)
    clean, noisy = _scene(rng, h=48, w=64)
    root = tmp_path / "anim"
    os.makedirs(root / "RenderElements", exist_ok=True)
    imageio.save(str(root / "frame_0000.png"), noisy)
    imageio.save(str(root / "RenderElements" / "albedo_0000.png"), clean)
    env = dict(os.environ, IDF_NO_PROGRESS="1")
    r_ = subprocess.run(
        [
            sys.executable,
            "-m",
            "image_denoising_filter.cli",
            str(root / "frame_0000.png"),
            "--configs",
            "layers",
            "--turbo",
            "2",
            "--output-dir",
            str(tmp_path),
        ],
        env=env,
        capture_output=True,
        text=True,
    )
    assert r_.returncode == 0, r_.stderr[-2000:]
    out_path = tmp_path / "output-nonlinear-bialteral-layers.png"
    assert out_path.exists()
    out, _ = imageio.load(str(out_path))
    assert np.isfinite(out).all()


@pytest.mark.parametrize("hw", [(50, 300), (97, 131)])
@pytest.mark.parametrize("d", [2, 4])
def test_turbo_odd_shapes(rng, hw, d):
    """Odd shapes that are not multiples of d go through the pad-to-d pool
    and the cropped upsample; output must stay finite and close to the
    exact kernel."""
    h, w = hw
    clean, noisy = _scene(rng, h=h, w=w)
    bp = BilateralParams()
    got = np.asarray(bilateral_fast(noisy, bp, 8, d))
    assert got.shape == (h, w, 4) and np.isfinite(got).all()
    from image_denoising_filter.ops import bilateral

    exact = np.asarray(bilateral(noisy, bp))
    db = ref.psnr(got[..., :3], exact[..., :3])
    assert db >= 35.0, f"odd-shape turbo d={d} vs exact: {db:.1f} dB"


def _guided_scene(rng, h=96, w=128):
    clean, noisy = _scene(rng, h=h, w=w)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    grad = np.stack(
        [xx / w, yy / h, (xx + yy) / (h + w), np.ones((h, w), np.float32)], -1
    ).astype(np.float32)
    return clean, noisy, [clean, grad]


def _turbo_layers(noisy, layers, lp, levels, d):
    from image_denoising_filter.ops import (
        cross_bilateral_layers_fast,
        normalize_layers_fast,
    )

    wc = nw = 0.0
    for layer in layers:
        pwc, pnw = cross_bilateral_layers_fast(noisy, layer, lp, levels, d)
        wc, nw = wc + pwc, nw + pnw
    return np.asarray(normalize_layers_fast(wc, nw))


@pytest.mark.parametrize("d,min_db", [(2, 35.0), (4, 32.0), (8, 27.0)])
def test_turbo_layers_guided_vs_exact_kernel(rng, d, min_db):
    """The plain-XLA guided grid (layer = guide, target = payload, splatted
    per pixel, per-channel num/den, tent slice) against the exact
    cross-bilateral kernel, accumulated over two layers and normalized."""
    from image_denoising_filter.config import LayersParams
    from image_denoising_filter.ops import cross_bilateral_layers, normalize

    _, noisy, layers = _guided_scene(rng)
    lp = LayersParams(radius=8)
    wc = nw = 0.0
    for layer in layers:
        pwc, pnw = cross_bilateral_layers(noisy, layer, lp)
        wc, nw = wc + pwc, nw + pnw
    exact = np.asarray(normalize(wc, nw))
    got = _turbo_layers(noisy, layers, lp, 6, d)
    db = ref.psnr(got[..., :3], exact[..., :3])
    assert db >= min_db, f"guided turbo d={d}: {db:.1f} dB < {min_db}"


def test_turbo_layers_partials_contract(rng):
    """Partials keep the exact pipeline's contract: weightColor (H, W, 4),
    per-channel normWeight (H, W, 3), both additive over layers; a layer
    equal to the target with one level reduces to a blur whose normalized
    output is the payload's Gaussian mean (range weights all 1)."""
    from image_denoising_filter.config import LayersParams
    from image_denoising_filter.ops import cross_bilateral_layers_fast

    _, noisy, layers = _guided_scene(rng, 40, 56)
    wc, nw = cross_bilateral_layers_fast(noisy, layers[1], LayersParams(), 5, 2)
    assert wc.shape == (40, 56, 4) and nw.shape == (40, 56, 3)
    assert np.all(np.asarray(nw) > 0)
    flat = np.full((40, 56, 4), 0.3, np.float32)
    out = _turbo_layers(flat, [flat], LayersParams(), 6, 2)
    np.testing.assert_allclose(out, 0.3, atol=1e-5)


@pytest.mark.parametrize("d", [2, 4])
def test_turbo_hdr_range_bilateral(rng, d):
    """HDR values above 1 and below 0 through the bilateral grid: the grid
    range comes from the data, so an affine HDR stretch of the scene must
    give the same affine stretch of the output (sigma_color scaled along)."""
    _, noisy = _scene(rng)
    a, b = 6.0, -1.5  # maps [0, 1] to [-1.5, 4.5]
    hdr = noisy.copy()
    hdr[..., :3] = a * noisy[..., :3] + b
    base = np.asarray(bilateral_fast(noisy, BilateralParams(), 6, d))
    got = np.asarray(
        bilateral_fast(hdr, BilateralParams(sigma_color=0.2 * a), 6, d)
    )
    assert np.isfinite(got).all() and got[..., :3].max() > 1.0
    assert got[..., :3].min() < 0.0
    np.testing.assert_allclose(got[..., :3], a * base[..., :3] + b, rtol=1e-4, atol=1e-4 * a)
    np.testing.assert_allclose(got[..., 3], base[..., 3], atol=1e-5)


@pytest.mark.parametrize("d", [2, 4])
def test_turbo_hdr_range_layers(rng, d):
    """HDR through the guided grid: stretching target and layers affinely
    (and sigma_color with them) stretches the normalized output the same
    way, values above 1 and below 0 included."""
    from image_denoising_filter.config import LayersParams

    _, noisy, layers = _guided_scene(rng)
    a, b = 5.0, -2.0

    def stretch(x):
        y = x.copy()
        y[..., :3] = a * x[..., :3] + b
        return y

    base = _turbo_layers(noisy, layers, LayersParams(), 6, d)
    got = _turbo_layers(
        stretch(noisy), [stretch(x) for x in layers],
        LayersParams(sigma_color=0.2 * a), 6, d,
    )
    assert np.isfinite(got).all() and got[..., :3].max() > 1.0
    assert got[..., :3].min() < 0.0
    np.testing.assert_allclose(got[..., :3], a * base[..., :3] + b, rtol=1e-4, atol=1e-4 * a)


@pytest.mark.parametrize("d,edge", [(2, 33), (4, 34)])
def test_turbo_edge_inside_a_cell(d, edge):
    """A step edge that splits a d x d cell: each pixel is splatted at its
    own level, so neither side bleeds into the other (pooling the cell
    first would put it on the levels in between: ~26 dB at d = 4)."""
    from image_denoising_filter.ops.xla import bilateral_xla

    img = np.ones((32, 64, 4), np.float32)
    img[..., :3] = 0.2
    img[:, edge:, :3] = 0.8
    img[:, edge:, 1] = 0.7
    bp = BilateralParams()
    got = np.asarray(bilateral_fast(img, bp, 5, d))
    exact = np.asarray(bilateral_xla(img, bp))
    db = ref.psnr(got[..., :3], exact[..., :3])
    assert db >= 45.0, f"edge inside a {d}-px cell: {db:.1f} dB"

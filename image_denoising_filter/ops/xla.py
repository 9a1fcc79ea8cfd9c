"""Pure-XLA (jnp) implementations of the device kernels.

These are the analog of the reference's *linear texel-buffer* layout variant
(shaders/bialteral_linear.comp, README.md:53-55): the same math as the
hand-tiled kernels of ops/stencils.py, but expressed as whole-image XLA ops
where the compiler owns layout and scheduling -- each tap or search offset
re-reads whole-image planes from HBM and carries its accumulators through HBM
instead of registers. Comparing this against the tiled kernels reproduces the
reference's tiled-vs-linear layout experiment.

They are also the plain reference each hand kernel is compared with on the
card, and the differentiable path. `normalize` is the one normalize pass for
both layouts: it is elementwise, and XLA fuses it.

All functions take/return (H, W, 4) float32 arrays and are jit-compatible with
the params objects static.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    BilateralParams,
    BorderPolicy,
    LayersParams,
    NlmParams,
    NormalizeParams,
)


def _pad2d(img: jnp.ndarray, r: int, border: str) -> jnp.ndarray:
    """Pad leading two (H, W) axes by r per the border policy."""
    if r == 0:
        return img
    widths = ((r, r), (r, r)) + ((0, 0),) * (img.ndim - 2)
    mode = "edge" if border == BorderPolicy.CLAMP else "constant"
    return jnp.pad(img, widths, mode=mode)


def _offsets_and_spatial(radius: int, sigma_spatial: float):
    """All (dy, dx) window offsets and their log spatial weights, as arrays."""
    r = radius
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    offs = np.stack([dy.ravel() + r, dx.ravel() + r], axis=1).astype(np.int32)
    log_sw = (-0.5 * (dy * dy + dx * dx).ravel() / (sigma_spatial**2)).astype(
        np.float32
    )
    return jnp.asarray(offs), jnp.asarray(log_sw)


@functools.partial(jax.jit, static_argnums=1)
def bilateral_xla(img: jnp.ndarray, params: BilateralParams) -> jnp.ndarray:
    """Bilateral filter (shaders/bialteral_linear.comp math; see
    ops/reference.py:bilateral_reference for the tap-level semantics)."""
    img = img.astype(jnp.float32)
    h, w, _ = img.shape
    r = params.effective_radius  # spatial-weight truncation (config.py)
    padded = _pad2d(img, r, params.border)
    offs, log_sw = _offsets_and_spatial(r, params.sigma_spatial)
    inv2sc = jnp.float32(0.5 / (params.sigma_color**2))
    center = img[..., :3]

    nch = 3 if params.uniform_alpha else 4

    def body(carry, off_and_lsw):
        wc, nw = carry
        off, lsw = off_and_lsw
        tap = jax.lax.dynamic_slice(padded, (off[0], off[1], 0), (h, w, 4))
        d = center - tap[..., :3]
        if params.blue_bug:
            d = d.at[..., 2].set(0.0)
        ssd = jnp.sum(d * d, axis=-1)
        wgt = jnp.exp(lsw - ssd * inv2sc)
        return (wc + tap[..., :nch] * wgt[..., None], nw + wgt), None

    init = (jnp.zeros((h, w, nch), jnp.float32), jnp.zeros((h, w), jnp.float32))
    (wc, nw), _ = jax.lax.scan(body, init, (offs, log_sw))
    if params.uniform_alpha:
        wc = jnp.concatenate([wc, img[..., 3:] * nw[..., None]], axis=-1)
    return wc / nw[..., None]


@functools.partial(jax.jit, static_argnums=2)
def cross_bilateral_layers_xla(
    target: jnp.ndarray, layer: jnp.ndarray, params: LayersParams
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One layer's cross-bilateral accumulation partials
    (shaders/bialteral_layers.comp:27-66): weights from `layer`, colors from
    `target`. Returns (weightColor, normWeight) for this layer."""
    target = target.astype(jnp.float32)
    layer = layer.astype(jnp.float32)
    h, w, _ = target.shape
    r = params.effective_radius  # spatial-weight truncation (config.py)
    padded_t = _pad2d(target, r, params.border)
    padded_l = _pad2d(layer, r, params.border)
    offs, log_sw = _offsets_and_spatial(r, params.sigma_spatial)
    inv2sc = jnp.float32(0.5 / (params.sigma_color**2))
    center_l = layer[..., :3]

    def body(carry, off_and_lsw):
        wc, nw = carry
        off, lsw = off_and_lsw
        tap_l = jax.lax.dynamic_slice(padded_l, (off[0], off[1], 0), (h, w, 4))
        tap_t = jax.lax.dynamic_slice(padded_t, (off[0], off[1], 0), (h, w, 4))
        d = center_l - tap_l[..., :3]
        if params.blue_bug:
            d = d.at[..., 2].set(0.0)
        ssd = jnp.sum(d * d, axis=-1)
        wgt = jnp.exp(lsw - ssd * inv2sc)
        return (wc + tap_t[..., :nch] * wgt[..., None], nw + wgt), None

    nch = 3 if params.uniform_alpha else 4
    init = (jnp.zeros((h, w, nch), jnp.float32), jnp.zeros((h, w), jnp.float32))
    (wc, nw), _ = jax.lax.scan(body, init, (offs, log_sw))
    if params.uniform_alpha:
        wc = jnp.concatenate([wc, target[..., 3:] * nw[..., None]], axis=-1)
    return wc, nw


@functools.partial(jax.jit, static_argnums=2)
def nlm_xla(
    target: jnp.ndarray, neighbour: jnp.ndarray, params: NlmParams
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One frame's NLM accumulation partials (shaders/nonlocal.comp:30-65).

    Uses the offset decomposition: for each search offset d, the patch SSD
    against the target is a 2p x 2p box sum of the per-pixel squared difference
    image E_d -- identical math to the naive quadruple loop up to floating-point
    reassociation, at ~10x fewer flops. Returns (weightColor, normWeight),
    normWeight seeded with params.norm_seed (shaders/nonlocal.comp:32).
    """
    target = target.astype(jnp.float32)
    neighbour = neighbour.astype(jnp.float32)
    h, w, _ = target.shape
    s, p = params.search_radius, params.patch_radius
    halo = s + p
    # E_d must exist at positions y+j for y in [0,h), j in [-p, p):
    # rows [-p, h+p-1), i.e. h+2p-1 rows starting at -p.
    eh, ew = h + 2 * p - 1, w + 2 * p - 1
    pt = _pad2d(target, p, params.border)[..., :3]
    pn = _pad2d(neighbour, halo, params.border)
    pn_rgb = pn[..., :3]
    inv_h2 = jnp.float32(1.0 / (params.h**2))

    # Search offsets are half-open: [-s, s) x [-s, s) (shaders/nonlocal.comp:36-38).
    # search_stride > 1 evaluates the approximate offset subset, phase-aligned
    # to include the zero offset (config.py).
    st = params.search_stride
    sy, sx = np.mgrid[s % st : 2 * s : st, s % st : 2 * s : st]
    offs_np = np.stack([sy.ravel(), sx.ravel()], axis=1).astype(np.int32)
    if params.search_disk:  # drop grid corners (config.NlmParams.search_disk)
        keep = (offs_np[:, 0] - s) ** 2 + (offs_np[:, 1] - s) ** 2 <= s * s
        offs_np = offs_np[keep]
    offs = jnp.asarray(offs_np)

    t_ext = pt[:eh, :ew]  # target patch region, fixed across offsets

    if params.weights_halfres:
        # Half-row-resolution weight field (config.NlmParams.weights_halfres;
        # quality: tests/test_fast.py). Weight cells live on
        # the absolute half-row lattice ih <-> full rows {2ih, 2ih+1}:
        #   Eh(ih, x') = mean over the two rows of the per-pixel sq diff,
        #   ssd_h(ih)  = kappa * sum_{a=-1..1} Eh(ih+a) boxed over 2p lanes
        #                (kappa=2: 3x2p half cells represent the 2p x 2p
        #                full box's 4p^2 taps at half the sample count),
        #   w(2i)   = 0.25 c(i-1) + 0.75 c(i)      (bilinear, half-pixel
        #   w(2i+1) = 0.75 c(i)   + 0.25 c(i+1)     centers).
        # Row offsets dy are even (stride 2, phase includes 0), so each
        # candidate lands exactly on the half lattice; lanes stay full-res.
        if st != 2 or p != 3:
            raise ValueError(
                "weights_halfres requires search_stride=2 and patch_radius=3"
            )
        kappa = jnp.float32(2.0)
        hc = (h + 1) // 2
        rp = 12  # row pad: n-cells [-5, hc+5) -> full rows [-10, 2*hc+10)
        tpad = jnp.pad(
            target[..., :3],
            ((rp, rp + 1), (halo, halo), (0, 0)),
            mode="edge" if params.border == BorderPolicy.CLAMP else "constant",
        )
        npad = jnp.pad(
            neighbour[..., :3],
            ((rp, rp + 1), (halo, halo), (0, 0)),
            mode="edge" if params.border == BorderPolicy.CLAMP else "constant",
        )

        def pool_rows(x, ih0, n_cells):
            blk = jax.lax.dynamic_slice_in_dim(
                x, rp + 2 * ih0, 2 * n_cells, axis=0
            )
            return 0.5 * (blk[0::2] + blk[1::2])

        t_half = pool_rows(tpad, -2, hc + 4)  # cells [-2, hc+2)
        n_half = pool_rows(npad, -5, hc + 10)  # cells [-5, hc+5)
        # E lane region x' in [-p, w+p-1): padded-lane index x' + halo.
        t_he = jax.lax.dynamic_slice(
            t_half, (0, halo - p, 0), (hc + 4, ew, 3)
        )

        def body(carry, off):
            wc, nw = carry
            ohy = (off[0] - s) // 2  # even dy -> exact half-row shift
            n_he = jax.lax.dynamic_slice(
                n_half, (3 + ohy, off[1], 0), (hc + 4, ew, 3)
            )
            d = t_he - n_he
            e = jnp.sum(d * d, axis=-1)
            ssd3 = e[:-2] + e[1:-1] + e[2:]  # cells [-1, hc+1)
            ssd = jax.lax.reduce_window(
                ssd3, 0.0, jax.lax.add, (1, 2 * p), (1, 1), "valid"
            )
            wh = jnp.exp(-(kappa * ssd) * inv_h2)  # (hc+2, w)
            even = 0.25 * wh[:-2] + 0.75 * wh[1:-1]
            odd = 0.75 * wh[1:-1] + 0.25 * wh[2:]
            wgt = jnp.stack([even, odd], axis=1).reshape(2 * hc, w)[:h]
            is_self = jnp.logical_and(off[0] == s, off[1] == s)
            wgt = wgt * jnp.where(is_self, 1.0, float(st * st))
            tap = jax.lax.dynamic_slice(
                pn, (off[0] + p, off[1] + p, 0), (h, w, 4)
            )
            return (wc + tap[..., :nch] * wgt[..., None], nw + wgt), None

    else:

        def body(carry, off):
            wc, nw = carry
            # E region in padded-neighbour coords starts at off (derivation:
            # the element at E-index e corresponds to absolute row e-p+dy,
            # which sits at padded row e-p+dy+halo = e+off_y).
            n_ext = jax.lax.dynamic_slice(
                pn_rgb, (off[0], off[1], 0), (eh, ew, 3)
            )
            d = t_ext - n_ext
            e = jnp.sum(d * d, axis=-1)
            ssd = jax.lax.reduce_window(
                e, 0.0, jax.lax.add, (2 * p, 2 * p), (1, 1), "valid"
            )
            wgt = jnp.exp(-ssd * inv_h2)
            if st > 1:
                # importance-sampling compensation for non-self offsets
                is_self = jnp.logical_and(off[0] == s, off[1] == s)
                wgt = wgt * jnp.where(is_self, 1.0, float(st * st))
            tap = jax.lax.dynamic_slice(
                pn, (off[0] + p, off[1] + p, 0), (h, w, 4)
            )
            return (wc + tap[..., :nch] * wgt[..., None], nw + wgt), None

    nch = 3 if params.uniform_alpha else 4
    init = (
        jnp.zeros((h, w, nch), jnp.float32),
        jnp.full((h, w), params.norm_seed, jnp.float32),
    )
    (wc, nw), _ = jax.lax.scan(body, init, offs)
    if params.uniform_alpha:
        # seed is not alpha-weighted (shaders/nonlocal.comp:32, 61)
        wc = jnp.concatenate(
            [wc, neighbour[..., 3:] * (nw - params.norm_seed)[..., None]], axis=-1
        )
    return wc, nw


@functools.partial(jax.jit, static_argnums=2)
def normalize(
    weight_color: jnp.ndarray,
    norm: jnp.ndarray,
    params: NormalizeParams = NormalizeParams(),
) -> jnp.ndarray:
    """Normalization pass (shaders/normalize.comp:30-44)."""
    sentinel = jnp.array(
        [params.sentinel_r, params.sentinel_g, params.sentinel_b, params.sentinel_a],
        jnp.float32,
    )
    zero = norm == 0.0
    safe = jnp.where(zero, 1.0, norm)
    out = weight_color / safe[..., None]
    return jnp.where(zero[..., None], sentinel, out)

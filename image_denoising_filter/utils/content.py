"""Synthetic render-like benchmark content.

The reference's workload is denoising Monte-Carlo renders (CornellBox /
Bathroom01 / WasteWhite animation frames, Animations/README.md:1): piecewise-
smooth surfaces, hard geometric edges, soft shading gradients -- locally
low-dynamic-range content. This generator produces a deterministic scene with
those statistics so benchmarks and quality gates can run on the content class
the framework targets without shipping binary assets. Full-range iid noise
remains the published worst case (see bench.py): it is NOT what a denoiser
denoises, and grid methods are content-dependent by design.
"""

from __future__ import annotations

import numpy as np


def synthetic_render(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A deterministic render-like RGBA float32 scene in [0, 1].

    Composition: a vertically-shaded background (soft gradient), a set of
    overlapping rectangles and disks with flat-ish albedos and per-surface
    shading gradients (hard edges between them), plus low-amplitude texture.
    Alpha is 1 (opaque LDR render). Noise is NOT added here -- callers add
    the noise they want to denoise.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yn, xn = yy / max(h - 1, 1), xx / max(w - 1, 1)

    # Background: cornell-style wall gradient, slightly colored.
    base = np.stack(
        [
            0.35 + 0.25 * yn,
            0.30 + 0.20 * yn,
            0.28 + 0.15 * yn,
        ],
        axis=-1,
    )

    # Opaque geometric surfaces: rectangles and disks with flat albedo +
    # a per-surface shading gradient (what a lit diffuse surface looks like).
    for _ in range(12):
        albedo = rng.uniform(0.1, 0.9, 3).astype(np.float32)
        gdir = rng.uniform(-1, 1, 2).astype(np.float32)
        gmag = rng.uniform(0.05, 0.25)
        shade = gmag * (gdir[0] * yn + gdir[1] * xn)
        if rng.uniform() < 0.5:
            y0, x0 = rng.uniform(0, 0.8, 2)
            dy, dx = rng.uniform(0.1, 0.45, 2)
            mask = (yn >= y0) & (yn < y0 + dy) & (xn >= x0) & (xn < x0 + dx)
        else:
            cy, cx = rng.uniform(0.1, 0.9, 2)
            r = rng.uniform(0.05, 0.25)
            aspect = w / max(h, 1)
            mask = ((yn - cy) ** 2 + ((xn - cx) / max(aspect, 1e-3) * 1.0) ** 2) < r * r
        surf = np.clip(albedo[None, None] + shade[..., None], 0.0, 1.0)
        base = np.where(mask[..., None], surf, base)

    # Low-amplitude texture (fine detail a denoiser must not flatten).
    tex = 0.02 * np.sin(xx / 3.1) * np.cos(yy / 4.7)
    rgb = np.clip(base + tex[..., None], 0.0, 1.0).astype(np.float32)

    # Anti-aliasing: real renders rasterize with pixel filtering (multi-sample
    # AA / reconstruction filters), so geometric edges span 1-2 px. A small
    # separable blur models that; infinitely hard edges would make this
    # harsher than any real frame.
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for axis in (0, 1):
        pad = [(1, 1) if a == axis else (0, 0) for a in range(3)]
        p = np.pad(rgb, pad, mode="edge")
        sl = [slice(None)] * 3
        acc = np.zeros_like(rgb)
        for t in range(3):
            sl[axis] = slice(t, t + rgb.shape[axis])
            acc += k[t] * p[tuple(sl)]
        rgb = acc
    rgb = rgb.astype(np.float32)
    alpha = np.ones((h, w, 1), np.float32)
    return np.concatenate([rgb, alpha], axis=-1)


def synthetic_render_expr(h: int, w: int, seed: int = 0):
    """Traceable twin of `synthetic_render`: the scene parameters are drawn
    on the host (tiny, same numpy RNG stream in the same order) and a
    zero-arg thunk evaluating the fields with jnp is returned. Call the
    thunk inside any jit -- standalone (`synthetic_render_device`) or fused
    into a larger content program. Matches the numpy
    version to float32 rounding (tests/test_content.py).
    """
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    # Draw every parameter in the SAME order as synthetic_render so both
    # versions produce the same scene.
    surfs = []
    for _ in range(12):
        albedo = rng.uniform(0.1, 0.9, 3).astype(np.float32)
        gdir = rng.uniform(-1, 1, 2).astype(np.float32)
        gmag = float(rng.uniform(0.05, 0.25))
        if rng.uniform() < 0.5:
            y0, x0 = rng.uniform(0, 0.8, 2)
            dy, dx = rng.uniform(0.1, 0.45, 2)
            geom = ("rect", float(y0), float(x0), float(dy), float(dx))
        else:
            cy, cx = rng.uniform(0.1, 0.9, 2)
            r = float(rng.uniform(0.05, 0.25))
            geom = ("disk", float(cy), float(cx), r)
        surfs.append((albedo, gdir, gmag, geom))

    def build():
        yy = jnp.broadcast_to(
            jnp.arange(h, dtype=jnp.float32)[:, None], (h, w)
        )
        xx = jnp.broadcast_to(
            jnp.arange(w, dtype=jnp.float32)[None, :], (h, w)
        )
        yn, xn = yy / max(h - 1, 1), xx / max(w - 1, 1)
        base = jnp.stack(
            [
                0.35 + 0.25 * yn,
                0.30 + 0.20 * yn,
                0.28 + 0.15 * yn,
            ],
            axis=-1,
        )
        aspect = w / max(h, 1)
        for albedo, gdir, gmag, geom in surfs:
            shade = gmag * (
                float(gdir[0]) * yn + float(gdir[1]) * xn
            )
            if geom[0] == "rect":
                _, y0, x0, dy, dx = geom
                mask = (
                    (yn >= y0) & (yn < y0 + dy) & (xn >= x0) & (xn < x0 + dx)
                )
            else:
                _, cy, cx, r = geom
                mask = (
                    (yn - cy) ** 2
                    + ((xn - cx) / max(aspect, 1e-3) * 1.0) ** 2
                ) < r * r
            surf = jnp.clip(
                jnp.asarray(albedo)[None, None] + shade[..., None], 0.0, 1.0
            )
            base = jnp.where(mask[..., None], surf, base)
        tex = 0.02 * jnp.sin(xx / 3.1) * jnp.cos(yy / 4.7)
        rgb = jnp.clip(base + tex[..., None], 0.0, 1.0)
        for axis in (0, 1):
            pad = [(1, 1) if a == axis else (0, 0) for a in range(3)]
            p = jnp.pad(rgb, pad, mode="edge")
            sl = [slice(None)] * 3
            acc = jnp.zeros_like(rgb)
            for t, kv in enumerate((0.25, 0.5, 0.25)):
                sl[axis] = slice(t, t + rgb.shape[axis])
                acc = acc + kv * p[tuple(sl)]
            rgb = acc
        alpha = jnp.ones((h, w, 1), jnp.float32)
        return jnp.concatenate([rgb, alpha], axis=-1)

    return build


def synthetic_render_device(h: int, w: int, seed: int = 0):
    """Device-evaluated `synthetic_render`: one jitted elementwise program,
    so the frame is made on the device without a host->device upload."""
    import jax

    return jax.jit(synthetic_render_expr(h, w, seed))()

"""Synthetic animation dataset generator.

The reference expects `Animations/<Scene>/` directories of numbered frames plus
`RenderElements`-style G-buffer layer subdirectories, downloaded from an
external archive (Animations/README.md, .gitignore:2-4). This tool generates a
structurally identical synthetic dataset (animated noisy renders of a
Cornell-box-like scene + albedo/normal/depth layers) so every code path --
multiframe NLM, layer-guided filtering, HDR -- can run without external data.

  python tools/make_dataset.py Animations/CornellBox --frames 10 --size 480x640
  python tools/make_dataset.py Animations/CornellBoxHDR --hdr --frames 10
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def render_frame(t: float, h: int, w: int, rng, noise: float = 0.08, hdr: bool = False):
    """A fake path-traced frame: moving sphere in a colored box, plus the
    noise-free G-buffer layers. Returns (noisy, {layer_name: image})."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    u, v = xx / w, yy / h

    # walls: left red, right green, back gray gradient
    albedo = np.stack(
        [
            np.where(u < 0.15, 0.9, np.where(u > 0.85, 0.2, 0.7 - 0.3 * v)),
            np.where(u < 0.15, 0.1, np.where(u > 0.85, 0.8, 0.7 - 0.3 * v)),
            np.where(u < 0.15, 0.1, np.where(u > 0.85, 0.2, 0.7 - 0.3 * v)),
        ],
        axis=-1,
    ).astype(np.float32)

    # moving sphere
    cx, cy, r0 = 0.35 + 0.3 * t, 0.55, 0.18
    d = np.sqrt((u - cx) ** 2 + (v - cy) ** 2)
    sphere = d < r0
    albedo[sphere] = np.array([0.85, 0.75, 0.3], np.float32)

    nz = np.sqrt(np.clip(r0 * r0 - (u - cx) ** 2 - (v - cy) ** 2, 0, None)) / r0
    normal = np.stack(
        [
            np.where(sphere, (u - cx) / r0, np.where(u < 0.15, 1.0, np.where(u > 0.85, -1.0, 0.0))),
            np.where(sphere, (v - cy) / r0, 0.0),
            np.where(sphere, nz, np.where((u >= 0.15) & (u <= 0.85), 1.0, 0.0)),
        ],
        axis=-1,
    ).astype(np.float32) * 0.5 + 0.5

    depth = np.where(sphere, 0.5 - 0.2 * nz, 0.2 + 0.8 * v).astype(np.float32)
    depth3 = np.repeat(depth[..., None], 3, axis=-1)

    light = 1.2 - 0.8 * d
    clean = albedo * np.clip(light, 0.1, None)[..., None]
    if hdr:
        # emissive ceiling patch pushes values past 1
        emit = ((v < 0.08) & (np.abs(u - 0.5) < 0.2)).astype(np.float32) * 4.0
        clean = clean + emit[..., None]
    else:
        clean = np.clip(clean, 0, 1)

    noisy = clean + rng.normal(0, noise, clean.shape).astype(np.float32)
    noisy = noisy if hdr else np.clip(noisy, 0, 1)

    def rgba(x):
        return np.concatenate([x, np.ones((h, w, 1), np.float32)], axis=-1)

    return rgba(noisy.astype(np.float32)), {
        "albedo": rgba(albedo),
        "normal": rgba(normal),
        "depth": rgba(depth3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir", help="e.g. Animations/CornellBox")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--size", default="240x320", help="HxW")
    ap.add_argument("--noise", type=float, default=0.08)
    ap.add_argument("--hdr", action="store_true", help="write .exr frames")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from image_denoising_filter.utils import imageio

    h, w = (int(x) for x in args.size.split("x"))
    rng = np.random.default_rng(args.seed)
    ext = "exr" if args.hdr else "png"
    layers_dir = os.path.join(args.outdir, "RenderElements")
    os.makedirs(layers_dir, exist_ok=True)

    for i in range(args.frames):
        t = i / max(args.frames - 1, 1)
        noisy, layers = render_frame(t, h, w, rng, args.noise, args.hdr)
        name = f"Animation01_{'HDR' if args.hdr else 'LDR'}_{i:04d}.{ext}"
        imageio.save(os.path.join(args.outdir, name), noisy)
        # layers are always LDR (the reference loads them with a_isHDR=false,
        # src/main.cpp:1396)
        for lname, img in layers.items():
            imageio.save(
                os.path.join(layers_dir, f"{lname}_{i:04d}.png"),
                np.clip(img, 0, 1),
            )
    print(f"wrote {args.frames} frames + layers to {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

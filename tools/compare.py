"""Output comparison tool: PSNR / per-channel stats between two images.

The reference's validation story is eyeballing output files side by side
(README.md:13-15, separate output-cpu.png vs output-nonlinear-bialteral.png);
this makes the comparison quantitative:

  python tools/compare.py output-nonlinear-bialteral.png output-cpu.png
  python tools/compare.py a.exr b.exr --interior 10
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument(
        "--interior", type=int, default=0, metavar="N",
        help="crop an N-pixel border before comparing (e.g. 10 for the CPU "
        "path's zeroed border)",
    )
    ap.add_argument("--channels", default="rgb", choices=["rgb", "rgba"])
    args = ap.parse_args(argv)

    from image_denoising_filter.ops.reference import psnr, ssim
    from image_denoising_filter.utils import imageio

    a, _ = imageio.load(args.a)
    b, _ = imageio.load(args.b)
    if a.shape != b.shape:
        print(f"shape mismatch: {a.shape} vs {b.shape}", file=sys.stderr)
        return 1
    if args.interior:
        n = args.interior
        if 2 * n >= min(a.shape[0], a.shape[1]):
            print(
                f"--interior {n} leaves no pixels on a "
                f"{a.shape[0]}x{a.shape[1]} image", file=sys.stderr,
            )
            return 1
        a, b = a[n:-n, n:-n], b[n:-n, n:-n]
    nch = 3 if args.channels == "rgb" else 4
    a, b = a[..., :nch], b[..., :nch]

    peak = max(1.0, float(a.max()), float(b.max()))
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    print(f"shape: {a.shape}   peak: {peak:g}")
    print(f"PSNR : {psnr(a, b, peak=peak):.2f} dB")
    print(f"SSIM : {ssim(a, b, peak=peak):.5f}")
    print(f"max |diff| : {d.max():.6g}   mean |diff| : {d.mean():.6g}")
    for c, name in enumerate("RGBA"[:nch]):
        print(f"  {name}: max {d[..., c].max():.6g}  mean {d[..., c].mean():.6g}")
    frac = float((d.max(axis=-1) > 1e-6).mean())
    print(f"pixels differing (>1e-6): {frac * 100:.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end serving throughput: decode -> upload -> denoise -> encode for
every frame in an animation directory (the --all-frames serving mode), timed
wall-clock — the number a production deployment cares about, including codec
and host<->device costs, not just kernel time.

Usage: python -u tools/serve_bench.py [--frames N] [--size 1080p|4k]
       [--config bilateral|nlm] [--turbo D]
Generates a synthetic animation, then runs the serving loop.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, ".")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", default="1080p", choices=["small", "1080p", "4k"])
    ap.add_argument("--config", default="bilateral", choices=["bilateral", "nlm"])
    ap.add_argument("--turbo", type=int, default=0, choices=[0, 1, 2, 4])
    args = ap.parse_args()

    from image_denoising_filter.config import (
        BilateralParams,
        NlmParams,
        RunConfig,
    )
    from image_denoising_filter.runtime.session import Session
    from image_denoising_filter.utils import compile_cache, imageio

    compile_cache.enable()
    shapes = {"small": (96, 128), "1080p": (1080, 1920), "4k": (2160, 3840)}
    h, w = shapes[args.size]
    rng = np.random.default_rng(0)

    tmp = tempfile.mkdtemp(prefix="serve_bench_")
    anim = os.path.join(tmp, "anim")
    os.makedirs(anim, exist_ok=True)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [
            0.5 + 0.4 * np.sin(xx / 37.0) * np.cos(yy / 23.0),
            0.5 + 0.4 * np.cos(xx / 53.0 + yy / 31.0),
            0.5 + 0.3 * np.sin((xx + yy) / 41.0),
            np.ones((h, w), np.float32),
        ],
        axis=-1,
    ).astype(np.float32)
    print(f"writing {args.frames} {args.size} frames to {anim} ...", flush=True)
    for i in range(args.frames):
        noisy = np.clip(
            base + rng.normal(0, 0.05, base.shape) * [1, 1, 1, 0], 0, 1
        ).astype(np.float32)
        imageio.save(os.path.join(anim, f"frame_{i:04d}.png"), noisy)

    cfg = (
        RunConfig()
        if args.config == "bilateral"
        else RunConfig(nlm=True)
    )
    frame_cache: dict = {}
    out_dir = os.path.join(tmp, "out")
    os.makedirs(out_dir, exist_ok=True)
    targets = sorted(
        os.path.join(anim, f) for f in os.listdir(anim) if f.endswith(".png")
    )

    def run_one(target, warmup):
        session = Session(
            target,
            bilateral_params=BilateralParams(),
            nlm_params=NlmParams(
                search_stride=2 if args.turbo else 1
            ),
            output_dir=out_dir,
            frame_cache=frame_cache,
            warmup=warmup,
        )
        if args.turbo and args.config == "bilateral":
            return session.run_turbo(cfg, downsample=args.turbo)
        return session.run(cfg)

    run_one(targets[0], warmup=True)  # compile outside the timed loop
    t0 = time.perf_counter()
    for tgt in targets:
        run_one(tgt, warmup=False)
    dt = time.perf_counter() - t0
    fps = len(targets) / dt
    mpix = len(targets) * h * w / dt / 1e6
    mode = f"turbo{args.turbo}" if args.turbo else "exact"
    print(
        f"serving {args.config} ({mode}) {args.size}: "
        f"{len(targets)} frames in {dt:.2f}s = {fps:.2f} frames/s "
        f"({mpix:.0f} Mpix/s end-to-end incl. decode+encode)",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI driver: runs the reference's fixed battery of configurations.

`idf-denoise [image-path]` mirrors `main()` (src/main.cpp:1935-1994): six GPU
configurations in fixed order, each printing its transfer/exec timing, then the
CPU bilateral with 1 and 8 threads printing wall-clock seconds. Output files
use the reference's flag-encoded names (src/main.cpp:1677-1682).
"""

from __future__ import annotations

import argparse
import sys

from .config import (
    GPU_BATTERY,
    BilateralParams,
    LayersParams,
    NlmParams,
    RunConfig,
)
from .runtime.session import Session
from .utils.timing import Timer, print_cpu_time

DEFAULT_IMAGE = "Animations/CornellBox/Animation01_LDR_0000.png"

_CONFIG_BANNERS = {
    # main.cpp:1952-1972 banners, modernized
    (False, False, False, False, False): "bilateral filter (tiled layout)",
    (False, False, False, False, True): "bilateral filter using layers",
    (False, True, False, False, False): "bilateral filter (linear layout)",
    (True, False, False, False, False): "non-local means filter",
    (True, False, True, False, False): "multiframe non-local means filter",
    (True, False, True, True, False): "multiframe NLM with copy/compute overlap",
}


def _banner(cfg: RunConfig) -> str:
    key = (cfg.nlm, cfg.linear, cfg.multiframe, cfg.overlap, cfg.use_layers)
    return _CONFIG_BANNERS.get(key, str(cfg))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="idf-denoise",
        description="GPU image denoising battery "
        "(bilateral / layer-guided / temporal NLM)",
    )
    ap.add_argument("image", nargs="?", default=DEFAULT_IMAGE, help="target image path")
    ap.add_argument("--output-dir", default=".", help="where output-*.png/.exr go")
    ap.add_argument(
        "--configs",
        default="all",
        help="comma list from: bilateral,layers,linear,nlm,multiframe,overlap,cpu1,cpu8 "
        "(default: all)",
    )
    ap.add_argument(
        "--clamp", action="store_true",
        help="saturating LDR quantization instead of the reference's wrapping cast",
    )
    ap.add_argument(
        "--debug-weights", action="store_true",
        help="dump sampled NLM/layers weight-accumulator values "
        "(the reference's disabled debug block, src/main.cpp:1628-1647)",
    )
    ap.add_argument(
        "--profile", metavar="DIR", default=None,
        help="write a jax.profiler trace of the battery to DIR",
    )
    ap.add_argument(
        "--mesh", default=None, metavar="FxY",
        help="multi-device mesh, e.g. 2x2 = 2-way frame DP x 2-way spatial "
        "row sharding (default: single device; exact kernels only)",
    )
    # Filter parameters (the reference requires editing main.cpp to change
    # these, README.md:3; defaults are the reference's push-constant values).
    ap.add_argument(
        "--all-frames", action="store_true",
        help="serving mode: run the selected configs for EVERY same-extension "
        "frame in the target's directory (outputs under output-dir/<frame-stem>/)",
    )
    ap.add_argument(
        "--turbo", type=int, default=0, metavar="D", choices=[0, 1, 2, 4, 8],
        help="approximate speed mode: bilateral-grid with spatial reduction D "
        "for the bilateral and layer-guided configs, stride-2 search for the "
        "NLM configs (0 = exact kernels; quality vs exact is gated at 40 dB; "
        "content-dependent -- targets renders/photos, not white noise). "
        "NOTE: under --turbo the 'linear' config runs the same grid pipeline "
        "as 'bilateral' (the tiled-vs-linear layout experiment is an "
        "exact-kernel concept), so those two outputs are the same "
        "computation under different filenames. Combine with "
        "--search-radius 6 for the trimmed-search NLM row (36 of 196 "
        "candidates). Single device only",
    )
    ap.add_argument(
        "--turbo-levels", type=int, default=None, metavar="K",
        help="override the bilateral-grid intensity-level count for --turbo "
        "(default: K=5 at D=2/4, K=6 otherwise)",
    )
    ap.add_argument(
        "--batch-frames", action="store_true",
        help="run non-overlap multiframe NLM as frame-batched kernel "
        "launches (stacked upload; weight accumulators stay in registers "
        "across frames) instead of one dispatch per frame; long sequences "
        "are chunked at ~1.5 GB of stacked frames to bound peak host/device "
        "memory",
    )
    ap.add_argument("--radius", type=int, default=20, help="bilateral window radius")
    ap.add_argument("--sigma-spatial", type=float, default=2.0)
    ap.add_argument("--sigma-color", type=float, default=0.2)
    ap.add_argument("--nlm-h", type=float, default=0.5, help="NLM filtering parameter")
    ap.add_argument("--search-radius", type=int, default=7, help="NLM search radius (half-open)")
    ap.add_argument("--patch-radius", type=int, default=3, help="NLM patch radius (half-open)")
    ap.add_argument(
        "--search-disk", action="store_true",
        help="trim NLM search candidates to the disk dy^2+dx^2 <= s^2 "
        "(with --turbo: 37 of 196 candidates)",
    )
    ap.add_argument(
        "--weights-halfres", action="store_true",
        help="compute the NLM weight field at half ROW resolution (bilinear "
        "row upsample; value taps stay full-res; runs on the XLA path); "
        "requires --turbo (stride-2 search) and patch radius 3; "
        "content-dependent on hard row edges",
    )
    args = ap.parse_args(argv)

    from .utils import compile_cache

    compile_cache.enable()

    sel = args.configs.split(",") if args.configs != "all" else [
        "bilateral", "layers", "linear", "nlm", "multiframe", "overlap", "cpu1", "cpu8"
    ]
    key_of = ["bilateral", "layers", "linear", "nlm", "multiframe", "overlap"]

    try:
        import os

        targets = [args.image]
        if args.all_frames:
            from .utils import dataset as dataset_mod

            if not os.path.exists(args.image):
                raise FileNotFoundError(args.image)
            targets = list(
                dataset_mod.discover(args.image, multiframe=True, max_frames=None).frames[1:]
            )
        mesh_shape = None
        if args.mesh:
            f, y = args.mesh.lower().split("x")
            mesh_shape = (int(f), int(y))
        bp = BilateralParams(
            radius=args.radius,
            sigma_spatial=args.sigma_spatial,
            sigma_color=args.sigma_color,
        )
        lp = LayersParams(
            radius=args.radius,
            sigma_spatial=args.sigma_spatial,
            sigma_color=args.sigma_color,
        )
        nlp = NlmParams(
            search_radius=args.search_radius,
            patch_radius=args.patch_radius,
            h=args.nlm_h,
            # Turbo's NLM analog: evaluate a strided search-candidate subset
            # (49 of 196 offsets at stride 2 -- quality gated in
            # tests/test_fast.py).
            search_stride=2 if args.turbo else 1,
            search_disk=args.search_disk,
            weights_halfres=args.weights_halfres,
        )
        if args.weights_halfres and not args.turbo:
            raise SystemExit(
                "--weights-halfres requires --turbo (stride-2 search)"
            )
        if args.turbo and mesh_shape and any(
            k in sel for k in ("bilateral", "layers", "linear")
        ):
            raise SystemExit(
                "--turbo with --mesh: the approximate bilateral-grid mode "
                "runs on one device only (drop --mesh, or select only NLM "
                "configs with --configs)"
            )
        profiler = None
        if args.profile:
            import jax

            try:
                jax.profiler.start_trace(args.profile)
                profiler = jax
            except Exception as e:
                print(f"profiler unavailable: {e}", file=sys.stderr)

        frame_cache: dict = {}
        os.makedirs(args.output_dir, exist_ok=True)
        for target in targets:
            out_dir = args.output_dir
            if args.all_frames:
                stem = os.path.splitext(os.path.basename(target))[0]
                out_dir = os.path.join(args.output_dir, stem)
                os.makedirs(out_dir, exist_ok=True)
                print(f"=== frame {stem} ===")
            session = Session(
                target,
                bilateral_params=bp,
                layers_params=lp,
                nlm_params=nlp,
                output_dir=out_dir,
                clamp_output=args.clamp,
                debug_weights=args.debug_weights,
                mesh_shape=mesh_shape,
                frame_cache=frame_cache,
                batch_frames=args.batch_frames,
            )
            for cfg, key in zip(GPU_BATTERY, key_of):
                if key not in sel:
                    continue
                print(f"<<<--- {_banner(cfg)} --->>>")
                if args.turbo and key in ("bilateral", "linear", "layers"):
                    result = session.run_turbo(
                        cfg, levels=args.turbo_levels, downsample=args.turbo
                    )
                else:
                    result = session.run(cfg)
                print(f"\toutput: {result.output_path}")
                result.report.print()

            for key, threads in (("cpu1", 1), ("cpu8", 8)):
                if key not in sel:
                    continue
                print(
                    f"<<<--- bilateral filter on cpu ({threads} thread"
                    f"{'s' if threads > 1 else ''}) --->>>"
                )
                timer = Timer()
                path, _ = session.run_cpu(threads)
                print(f"\toutput: {path}")
                print_cpu_time(timer)
        if profiler is not None:
            profiler.profiler.stop_trace()
            print(f"\tprofile trace written to {args.profile}")
    except Exception as e:  # main.cpp:1948-1991 catches and reports
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

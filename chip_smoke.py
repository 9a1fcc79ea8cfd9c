"""Smoke test of the denoising battery on one NVIDIA GPU.

    python chip_smoke.py                 # one card: every phase below
    python chip_smoke.py --out DIR       # also write the full record to DIR
    python chip_smoke.py --multi         # four cards: the sharded path only

Phases (one card), each of which must pass:

  oracle    the GPU kernels (bilateral, cross-bilateral, NLM, frame-batched
            NLM with a masked frame) vs the NumPy oracles at 96x128;
  card      the `gpu`-marked tests, in this process: each compiled kernel vs
            its ops/xla.py counterpart at 1080p (rtol 1e-4, atol 1e-5);
  battery   a 10-frame 1080p dataset from tools/make_dataset.py, then the six
            device configurations through cli.main with the reference
            parameters; every output file is reopened and must beat the noisy
            input's PSNR against the clean frame;
  paths     --batch-frames, --turbo 2 and --turbo 4 (bilateral grid for the
            bilateral/layers configs, stride-2 search for NLM, alone and with
            --search-disk) through cli.main, with the same output checks;
  gates     every approximate mode vs the exact kernels at 1080p (40 dB);
  timing    each hand kernel vs what XLA makes of ops/xla.py at 1080p and 4K
            (warmed, median of 5, jax.block_until_ready);
  e2e       each configuration that runs a hand kernel vs the same
            configuration on the linear (XLA) layout, through Session
            (5 warmed runs per side, interleaved; median, min, max);
  overlap   one jax.profiler trace of the `overlap` config: does the upload of
            frame k+1 overlap the NLM kernel on frame k, and how long does the
            host spend loading frames? (reported, not gated).

--multi runs only the four-card path: the bilateral, layers, nlm, multiframe
and overlap configs on a 2x2 (frame x y) mesh at 1080p, each compared with the
single-card output of the same Session.

The script needs the repository beside it and a GPU: without either it exits
nonzero and prints no result. Its first line is the card's name and power
limit; its last line is one JSON object with the device as JAX reports it.
Everything runs in this one process (a second JAX process would find most of
the card's memory already reserved).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SIZE_1080P = (1080, 1920)
SIZE_4K = (2160, 3840)
FRAMES = 10
GATE_DB = 40.0
RTOL, ATOL = 1e-4, 1e-5
DEVICE_CONFIGS = ("bilateral", "layers", "linear", "nlm", "multiframe", "overlap")
# The configurations that run a hand kernel (all but `linear`).
TILED_CONFIGS = ("bilateral", "layers", "nlm", "multiframe", "overlap")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return r.stdout.strip().splitlines()[0]


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    from image_denoising_filter.ops import reference as ref

    return float(ref.psnr(a[..., :3], b[..., :3]))


def _close(name: str, got, want, rtol: float = RTOL, atol: float = ATOL) -> float:
    """assert_allclose, returning the worst |err| / (atol + rtol |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


def _noisy(h: int, w: int, seed: int) -> np.ndarray:
    from image_denoising_filter.utils.content import synthetic_render

    rng = np.random.default_rng(seed)
    img = synthetic_render(h, w, seed=seed)
    img[..., :3] += rng.normal(0, 0.05, (h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


def phase_oracle(h: int = 96, w: int = 128) -> dict:
    """Every GPU kernel vs its NumPy oracle, reference parameters."""
    from image_denoising_filter.config import BilateralParams, LayersParams, NlmParams
    from image_denoising_filter.ops import reference as ref
    from image_denoising_filter.ops import stencils

    a, b, c = _noisy(h, w, 1), _noisy(h, w, 2), _noisy(h, w, 3)
    bp, lp, npar = BilateralParams(), LayersParams(), NlmParams()
    out = {}
    out["bilateral"] = _close(
        "bilateral", stencils.bilateral(a, bp), ref.bilateral_reference(a, bp)
    )
    got = stencils.cross_bilateral_layers(a, b, lp)
    want = ref.cross_bilateral_layers_reference(a, b, lp)
    out["layers"] = max(_close("layers", g, x) for g, x in zip(got, want))
    got = stencils.nlm_accumulate(a, b, npar)
    want = ref.nlm_reference(a, b, npar)
    out["nlm"] = max(_close("nlm", g, x) for g, x in zip(got, want))
    valid = np.array([1.0, 0.0, 1.0], np.float32)
    got = stencils.nlm_accumulate_frames(a, np.stack([b, c, a]), npar, None, valid)
    parts = [ref.nlm_reference(a, f, npar) for f in (b, a)]
    want = [parts[0][i] + parts[1][i] for i in range(2)]
    out["nlm_frames_masked"] = max(
        _close("nlm_frames", g, x) for g, x in zip(got, want)
    )
    return out


def phase_card_tests() -> dict:
    """The repository's `gpu`-marked tests, run in this process."""
    import pytest

    os.environ["IDF_GPU_TESTS"] = "1"
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", os.path.join(HERE, "tests")]
    )
    if rc != 0:
        raise RuntimeError(f"gpu-marked tests failed (pytest rc {rc})")
    return {"pytest_rc": int(rc)}


def make_data(root: str, h: int, w: int, frames: int = FRAMES) -> tuple[str, np.ndarray]:
    """A synthetic animation with tools/make_dataset.py (in-process). Returns
    the target frame's path and its clean (noise-free) image."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import make_dataset

    scene = os.path.join(root, "CornellBox")
    make_dataset.main([scene, "--frames", str(frames), "--size", f"{h}x{w}"])
    clean, _ = make_dataset.render_frame(0.0, h, w, np.random.default_rng(0), noise=0.0)
    return os.path.join(scene, "Animation01_LDR_0000.png"), clean


def _run_cli(args: list[str]) -> None:
    from image_denoising_filter import cli

    rc = cli.main(args)
    if rc != 0:
        raise RuntimeError(f"cli.main({' '.join(args)}) returned {rc}")


def _check_outputs(out_dir: str, target: str, clean: np.ndarray, configs) -> dict:
    """Reopen every configuration's output; each must beat the noisy input's
    PSNR against the clean frame."""
    from image_denoising_filter.config import GPU_BATTERY
    from image_denoising_filter.utils import imageio

    noisy, _ = imageio.load(target)
    base = _psnr(noisy, clean)
    keys = dict(zip(DEVICE_CONFIGS, GPU_BATTERY))
    out = {"noisy_db": base}
    for key in configs:
        path = os.path.join(out_dir, keys[key].output_name(False))
        img, _ = imageio.load(path)
        if img.shape != noisy.shape or not np.isfinite(img).all():
            raise RuntimeError(f"{path}: bad output {img.shape}")
        db = _psnr(img, clean)
        if not db > base:
            raise RuntimeError(f"{key}: {db:.2f} dB does not beat noisy {base:.2f} dB")
        out[key] = db
    return out


def phase_battery(target: str, clean: np.ndarray, out_dir: str) -> dict:
    """The six device configurations, reference parameters, via cli.main."""
    _run_cli([target, "--output-dir", out_dir, "--clamp", "--configs", ",".join(DEVICE_CONFIGS)])
    return _check_outputs(out_dir, target, clean, DEVICE_CONFIGS)


def phase_paths(target: str, clean: np.ndarray, out_dir: str) -> dict:
    """--batch-frames, --turbo 2 / 4, and the disk-trimmed turbo search."""
    runs = {
        "batch_frames": (["--batch-frames"], ("multiframe",)),
        "turbo2": (["--turbo", "2"], ("bilateral", "layers", "nlm", "multiframe")),
        "turbo4": (["--turbo", "4"], ("bilateral", "layers", "nlm", "multiframe")),
        "turbo2_disk": (["--turbo", "2", "--search-disk"], ("nlm", "multiframe")),
    }
    out = {}
    for name, (flags, configs) in runs.items():
        sub = os.path.join(out_dir, name)
        _run_cli([target, "--output-dir", sub, "--clamp", "--configs", ",".join(configs), *flags])
        out[name] = _check_outputs(sub, target, clean, configs)
    return out


def phase_gates(h: int, w: int) -> dict:
    """Every approximate mode vs the exact kernels at (h, w), in dB: each
    must clear GATE_DB."""
    from image_denoising_filter.config import BilateralParams, LayersParams, NlmParams
    from image_denoising_filter.ops import (
        bilateral,
        bilateral_fast,
        cross_bilateral_layers,
        cross_bilateral_layers_fast,
        nlm_accumulate,
        normalize,
        normalize_layers_fast,
    )
    from image_denoising_filter.utils.content import synthetic_render

    k = 5  # Session.run_turbo's default at d = 2 and 4
    bp, lp = BilateralParams(), LayersParams()
    img = _noisy(h, w, 5)
    guide = synthetic_render(h, w, seed=5)
    exact_b = np.asarray(bilateral(img, bp))
    out = {
        f"bilateral_d{d}": _psnr(np.asarray(bilateral_fast(img, bp, k, d)), exact_b)
        for d in (2, 4)
    }
    exact_l = np.asarray(normalize(*cross_bilateral_layers(img, guide, lp)))
    for d in (2, 4):
        got = normalize_layers_fast(*cross_bilateral_layers_fast(img, guide, lp, k, d))
        out[f"layers_d{d}"] = _psnr(np.asarray(got), exact_l)
    exact_n = np.asarray(normalize(*nlm_accumulate(img, img, NlmParams())))
    for name, p in {
        "nlm_stride2": NlmParams(search_stride=2),
        "nlm_stride2_disk": NlmParams(search_stride=2, search_disk=True),
    }.items():
        out[name] = _psnr(np.asarray(normalize(*nlm_accumulate(img, img, p))), exact_n)
    bad = {k: v for k, v in out.items() if not v >= GATE_DB}
    if bad:
        raise RuntimeError(f"below the {GATE_DB} dB gate: {bad}")
    return out


def phase_timing(sizes=(SIZE_1080P, SIZE_4K), frames: int = FRAMES, reps: int = 5) -> dict:
    """Each hand kernel vs its XLA counterpart, in ms."""
    import jax
    import jax.numpy as jnp

    from image_denoising_filter.config import BilateralParams, LayersParams, NlmParams
    from image_denoising_filter.ops import stencils
    from image_denoising_filter.ops import xla as ops_xla
    from image_denoising_filter.utils.timing import device_time_ms

    bp, lp, npar = BilateralParams(), LayersParams(), NlmParams()

    @jax.jit
    def xla_frames(t, fr):
        def body(c, f):
            wc, nw = ops_xla.nlm_xla(t, f, npar)
            return (c[0] + wc, c[1] + nw), None

        init = (jnp.zeros(t.shape, jnp.float32), jnp.zeros(t.shape[:2], jnp.float32))
        return jax.lax.scan(body, init, fr)[0]

    from image_denoising_filter.utils.content import synthetic_render

    @functools.partial(jax.jit, static_argnums=1)
    def noisy_frames(scene, n):  # n noisy realizations, made on the device
        noise = 0.05 * jax.random.normal(jax.random.PRNGKey(n), (n,) + scene.shape)
        return jnp.clip(scene + noise.at[..., 3].set(0.0), 0.0, 1.0)

    out = {}
    for h, w in sizes:
        scene = jax.device_put(synthetic_render(h, w, seed=7))
        t, g = noisy_frames(scene, 2)
        fr = noisy_frames(scene, frames)
        cases = {
            "bilateral": (lambda x: stencils.bilateral(x, bp), lambda x: ops_xla.bilateral_xla(x, bp), (t,)),
            "layers_one": (
                lambda x, y: stencils.cross_bilateral_layers(x, y, lp),
                lambda x, y: ops_xla.cross_bilateral_layers_xla(x, y, lp),
                (t, g),
            ),
            "nlm_one": (
                lambda x, y: stencils.nlm_accumulate(x, y, npar),
                lambda x, y: ops_xla.nlm_xla(x, y, npar),
                (t, g),
            ),
            f"nlm_{frames}frames": (
                lambda x, f: stencils.nlm_accumulate_frames(x, f, npar),
                xla_frames,
                (t, fr),
            ),
        }
        for name, (kern, plain, args) in cases.items():
            out[f"{name}_{h}p"] = {
                "kernel_ms": device_time_ms(kern, *args, reps=reps),
                "xla_ms": device_time_ms(plain, *args, reps=reps),
            }
        del scene, t, g, fr
    return out


def phase_e2e(target: str, out_dir: str, reps: int = 5) -> dict:
    """Each configuration that runs a hand kernel vs the same configuration
    on the linear layout, which runs the XLA version of ops/xla.py instead:
    the Session's execution time of each, in ms, over `reps` warmed runs per
    side, the two sides interleaved (median, min, max). A kernel stays only
    where its configuration is faster end to end with it."""
    import dataclasses

    from image_denoising_filter.config import GPU_BATTERY
    from image_denoising_filter.runtime import Session

    keys = dict(zip(DEVICE_CONFIGS, GPU_BATTERY))
    sub = os.path.join(out_dir, "e2e")
    os.makedirs(sub, exist_ok=True)
    out = {}
    for key in TILED_CONFIGS:
        sides = {
            "kernel": keys[key],
            "xla": dataclasses.replace(keys[key], linear=True),
        }
        session = Session(target, output_dir=sub)
        times: dict = {side: [] for side in sides}
        for _ in range(reps):
            for side, cfg in sides.items():
                times[side].append(session.run(cfg).report.exec_ns / 1e6)
        out[key] = {
            f"{side}_exec_ms": {"median": float(np.median(t)), "min": min(t), "max": max(t)}
            for side, t in times.items()
        }
    return out


def _trace_events(trace_dir: str):
    """(name, start_ns, end_ns, plane) for every event on a device or host
    plane."""
    import glob

    import jax

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)
    if not paths:
        raise RuntimeError(f"no trace under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(paths[0])
    events = []
    for plane in data.planes:
        if "/device:" not in plane.name and "/host:" not in plane.name:
            continue
        for line in plane.lines:
            for ev in line.events:
                events.append((ev.name, ev.start_ns, ev.start_ns + ev.duration_ns, plane.name))
    return events


def overlap_summary(events) -> dict:
    """Host-to-device copies vs NLM kernels on the device timeline: how many
    uploads run (partly) while an NLM kernel runs, and the overlapped time;
    and the host's `load_frame` spans (decoding the frames it uploads)."""
    loads = [e for e in events if e[0] == "load_frame" and "/host:" in e[3]]
    events = [e for e in events if "/device:" in e[3]]
    uploads = [e for e in events if "memcpy" in e[0].lower() and ("htod" in e[0].lower() or "h2d" in e[0].lower())]
    kernels = [e for e in events if "nlm" in e[0].lower()]
    overlapped_ns, n_overlapping = 0, 0
    for _, s, e, _ in uploads:
        ov = sum(max(0, min(e, ke) - max(s, ks)) for _, ks, ke, _ in kernels)
        if ov > 0:
            n_overlapping += 1
        overlapped_ns += ov
    top: dict = {}
    for name, s, e, _ in events:
        top[name] = top.get(name, 0) + (e - s)
    return {
        "uploads": len(uploads),
        "nlm_kernels": len(kernels),
        "uploads_overlapping_nlm": n_overlapping,
        "overlapped_ms": overlapped_ns / 1e6,
        "upload_ms": sum(e - s for _, s, e, _ in uploads) / 1e6,
        "host_load_frames": len(loads),
        "host_load_frame_ms": sum(e - s for _, s, e, _ in loads) / 1e6,
        "top_device_events_ms": {
            k[:80]: v / 1e6 for k, v in sorted(top.items(), key=lambda kv: -kv[1])[:12]
        },
    }


def phase_overlap(target: str, out_dir: str) -> dict:
    """Trace the overlap config once and summarize upload/kernel overlap."""
    trace_dir = os.path.join(out_dir, "trace_overlap")
    _run_cli([target, "--output-dir", out_dir, "--configs", "overlap", "--profile", trace_dir])
    return overlap_summary(_trace_events(trace_dir))


def phase_multi(target: str, out_dir: str, mesh=(2, 2)) -> dict:
    """The sharded path: each config on a (frame, y) mesh vs one card."""
    from image_denoising_filter.config import GPU_BATTERY
    from image_denoising_filter.runtime import Session

    keys = dict(zip(DEVICE_CONFIGS, GPU_BATTERY))
    dirs = [os.path.join(out_dir, d) for d in ("one", "mesh")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    out = {}
    for key in TILED_CONFIGS:
        cfg = keys[key]
        one = Session(target, output_dir=dirs[0]).run(cfg)
        many = Session(target, output_dir=dirs[1], mesh_shape=mesh).run(cfg)
        out[key] = {
            "worst_ratio": _close(f"mesh {key}", many.image, one.image),
            "exec_ms_one": one.report.exec_ns / 1e6,
            "exec_ms_mesh_incl_compile": many.report.exec_ns / 1e6,
        }
    return out


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true", help="four-card sharded path only")
    ap.add_argument("--out", default=None, help="directory for the full JSON record")
    args = ap.parse_args(argv)

    try:
        import jax

        import image_denoising_filter as pkg
        from image_denoising_filter.utils import compile_cache
    except ImportError as e:
        print(f"chip_smoke: the repository is not importable here: {e}", file=sys.stderr)
        return 2
    if not os.path.abspath(pkg.__file__).startswith(HERE + os.sep):
        print(f"chip_smoke: the package is not the one beside this script ({pkg.__file__})",
              file=sys.stderr)
        return 2
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform})", file=sys.stderr)
        return 2
    need = 4 if args.multi else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    os.environ.setdefault("IDF_NO_PROGRESS", "1")
    compile_cache.enable()

    record: dict = {}
    failed: list[str] = []

    def run(name, fn, *a):
        t0 = time.perf_counter()
        print(f"=== phase {name}", flush=True)
        try:
            record[name] = fn(*a)
            status = "ok"
        except Exception as e:  # a failed phase fails the run, after the rest
            record[name] = {"error": f"{type(e).__name__}: {e}"[:2000]}
            failed.append(name)
            status = "FAILED"
        record[name + "_s"] = time.perf_counter() - t0
        print(f"=== phase {name} {status} ({record[name + '_s']:.1f} s): "
              f"{json.dumps(record[name], default=float)[:1500]}", flush=True)

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    target, clean = make_data(work, *SIZE_1080P)
    outputs = os.path.join(work, "out")
    if args.multi:
        run("multi", phase_multi, target, outputs)
    else:
        run("oracle", phase_oracle)
        run("card", phase_card_tests)
        run("battery", phase_battery, target, clean, outputs)
        run("paths", phase_paths, target, clean, outputs)
        run("gates", phase_gates, *SIZE_1080P)
        run("timing", phase_timing)
        run("e2e", phase_e2e, target, outputs)
        run("overlap", phase_overlap, target, outputs)

    device = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
    record["device"] = device
    record["card"] = card_line()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        name = "chip_smoke_multi.json" if args.multi else "chip_smoke.json"
        with open(os.path.join(args.out, name), "w") as f:
            json.dump(record, f, indent=1, default=float)
    print(record["card"], flush=True)
    if failed:
        print(json.dumps({"ok": False, "failed": failed, "device": device}))
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

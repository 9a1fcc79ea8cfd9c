"""Benchmark: the exact GPU kernels and the quality-gated approximate modes at
4K (and the exact kernels and the temporal stream at 1080p) on one GPU.

    python bench.py              # on the card
    BENCH_SMOKE=1 python bench.py   # tiny shapes on the CPU: wiring only

Prints one JSON record line after every phase; the last line is the record.
Every time is the median of warmed calls ended by jax.block_until_ready
(utils/timing.py:device_time_ms) and is reported as Mpix/s. Every approximate
setting is gated at 40 dB vs the exact kernel on the same 4K render-like
content; gate-failing settings publish their throughput with gate_ok=false and
never carry the best-gated fields. A failed phase is noted and the next one
runs; a phase that no longer fits the BENCH_DEADLINE_S budget is skipped with
a note. The record names the device it ran on; in smoke mode the numbers say
nothing about any device.
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np

GATE_DB = 40.0
DEADLINE_S = float(os.environ.get("BENCH_DEADLINE_S", "1500"))
SMOKE = os.environ.get("BENCH_SMOKE", "") == "1"
_T0 = time.monotonic()


def _remaining() -> float:
    return DEADLINE_S - (time.monotonic() - _T0)


# Bilateral-grid settings reachable through --turbo D: (d, levels, sigma_s or
# None for the reference default). K=5 is Session.run_turbo's default at d=2
# and d=4; d=8 gates only with a wider spatial sigma.
TURBO_SETTINGS = ((4, 5, None), (2, 5, None), (8, 6, 6.0))
# NLM turbo settings: (search_radius, stride, disk, weights_halfres).
NLM_TURBO_SETTINGS = (
    (7, 2, False, False),
    (6, 2, False, False),
    (7, 2, True, False),
    (6, 2, True, False),
    (6, 2, True, True),
)
NLM_TAGS = {
    (7, 2, False, False): "nlm_turbo",
    (6, 2, False, False): "nlm_turbo_s6",
    (7, 2, True, False): "nlm_turbo_disk",
    (6, 2, True, False): "nlm_turbo_s6disk",
    (6, 2, True, True): "nlm_turbo_s6hrwdisk",
}
# Guided-layers turbo downsamples (one layer of the layers battery config).
LAYERS_TURBO_DS = (2, 4)
LAYERS_LEVELS = 5


class _Record:
    """All measured state + the emit path. `emit()` assembles the JSON record
    from whatever has been measured so far and prints it as one line."""

    def __init__(self):
        self.out: dict = {
            "metric": "exact-kernel 4K throughput, geomean of bilateral and NLM",
            "value": 0.0,
            "unit": "Mpix/s",
        }
        self.turbo: dict = {}  # (d, K, sigma) -> mpix
        self.gates: dict = {}  # (d, K, sigma) -> db
        self.gate_ok: dict = {}
        self.nlm_turbo: dict = {}
        self.nlm_gates: dict = {}
        self.nlm_gate_ok: dict = {}
        self.layers_turbo: dict = {}
        self.layers_gates: dict = {}
        self.layers_gate_ok: dict = {}
        self.failures: list[str] = []

    def note(self, msg: str) -> None:
        self.out.setdefault("phase_errors", []).append(msg[:300])

    @staticmethod
    def _tag(d: int, K: int, sigma) -> str:
        tag = f"turbo_d{d}" if K == 6 else f"turbo_d{d}k{K}"
        if sigma is not None:
            tag += f"s{sigma:g}"
        return tag

    def _rows(self, out, rows, gates, gate_ok, tag_of, suffix) -> float:
        """Publish rows + gates; return the best gated throughput."""
        best = 0.0
        for key, mpix in rows.items():
            tag = tag_of(key)
            out[f"{tag}{suffix}_mpix_s"] = mpix
            if key in gates:
                out[f"{tag}{suffix}_db_vs_exact"] = gates[key]
            ok = bool(gate_ok.get(key, False))
            out[f"{tag}_gate_ok"] = ok
            if ok:
                best = max(best, mpix)
        return best

    def _assemble(self) -> None:
        out = self.out
        out["best_gated_turbo_4k_mpix_s"] = self._rows(
            out, dict(self.turbo), self.gates, self.gate_ok,
            lambda k: self._tag(*k), "_4k",
        )
        out["best_gated_nlm_turbo_4k_mpix_s"] = self._rows(
            out, dict(self.nlm_turbo), self.nlm_gates, self.nlm_gate_ok,
            NLM_TAGS.get, "_4k",
        )
        out["best_gated_layers_turbo_4k_mpix_s"] = self._rows(
            out, dict(self.layers_turbo), self.layers_gates,
            self.layers_gate_ok, lambda d: f"layers_turbo_d{d}", "_4k",
        )
        b = out.get("bilateral_4k_mpix_s", 0.0)
        n = out.get("nlm_4k_mpix_s", 0.0)
        value = math.sqrt(b * n)
        failures = list(self.failures)
        if failures:
            value = 0.0
            for k in list(out):
                if k.startswith("best_gated"):
                    out[k] = 0.0
        out["exact_check_failures"] = failures
        out["value"] = value
        out["elapsed_s"] = round(time.monotonic() - _T0, 1)
        if "phase_errors" in out:
            out["degraded"] = True

    def emit(self) -> None:
        try:
            self._assemble()
        except Exception as e:  # noqa: BLE001 -- emit must never fail
            self.out["assemble_error"] = f"{type(e).__name__}: {e}"[:300]
        print(json.dumps(self.out), flush=True)


class _Phases:
    """Run measurement phases with individual failure fencing and deadline
    gating; a checkpoint record is emitted after every phase either way."""

    RESERVE_S = 20.0  # wall-clock kept for the final emit

    def __init__(self, rec: _Record):
        self.rec = rec

    def run(self, name: str, fn, est_s: float = 60.0) -> bool:
        ok = False
        if _remaining() < est_s + self.RESERVE_S:
            self.rec.note(
                f"{name}: skipped (deadline: {_remaining():.0f}s left, "
                f"needs ~{est_s:.0f}s)"
            )
        else:
            try:
                fn()
                ok = True
            except Exception as e:  # noqa: BLE001 -- record, degrade, go on
                self.rec.note(f"{name}: {type(e).__name__}: {e}")
        self.rec.emit()
        return ok


def _measure(rec: _Record, phases: _Phases) -> None:
    import jax
    import jax.numpy as jnp

    from image_denoising_filter.config import (
        BilateralParams,
        CpuBilateralParams,
        LayersParams,
        NlmParams,
    )
    from image_denoising_filter.ops import (
        bilateral,
        bilateral_fast,
        cross_bilateral_layers,
        cross_bilateral_layers_fast,
        nlm_accumulate,
        nlm_accumulate_frames,
        normalize,
        normalize_layers_fast,
    )
    from image_denoising_filter.ops import reference as ref
    from image_denoising_filter.utils import compile_cache
    from image_denoising_filter.utils.content import synthetic_render
    from image_denoising_filter.utils.timing import device_time_ms

    if SMOKE:
        jax.config.update("jax_platforms", "cpu")
    compile_cache.enable()
    dev = jax.devices()[0]
    out = rec.out
    out["device"] = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }

    h, w = (64, 128) if SMOKE else (2160, 3840)
    hh, ww = (32, 64) if SMOKE else (1080, 1920)
    reps = 1 if SMOKE else 5

    @jax.jit
    def noisy(scene, key):
        n = 0.05 * jax.random.normal(key, scene.shape)
        return jnp.clip(scene + n.at[..., 3].set(0.0), 0.0, 1.0)

    scene = jax.device_put(synthetic_render(h, w, seed=1))
    guide = jax.device_put(synthetic_render(h, w, seed=2))
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    render, render2 = noisy(scene, k1), noisy(scene, k2)

    def mpix(fn, *args, n_px=h * w) -> float:
        return n_px / (device_time_ms(fn, *args, reps=reps) * 1e3)

    def psnr(a, b) -> float:
        return float(ref.psnr(np.asarray(a)[..., :3], np.asarray(b)[..., :3]))

    bp = BilateralParams(uniform_alpha=True)  # reference GPU params
    nlp = NlmParams(uniform_alpha=True)  # s=7 p=3 h=0.5
    lp = LayersParams()
    exact: dict = {}

    def phase_exact_4k():
        rec.out["bilateral_4k_mpix_s"] = mpix(lambda x: bilateral(x, bp), render)
        rec.out["nlm_4k_mpix_s"] = mpix(
            lambda x, y: nlm_accumulate(x, y, nlp), render, render2
        )

    def exact_bilateral(sg):
        if ("b", sg) not in exact:
            p = bp if sg is None else BilateralParams(uniform_alpha=True, sigma_spatial=sg)
            exact[("b", sg)] = bilateral(render, p)
        return exact[("b", sg)]

    def phase_turbo_bilateral():
        for d, K, sg in TURBO_SETTINGS:
            p = bp if sg is None else BilateralParams(uniform_alpha=True, sigma_spatial=sg)
            fn = lambda x: bilateral_fast(x, p, K, d)  # noqa: E731
            rec.turbo[(d, K, sg)] = mpix(fn, render)
            db = psnr(fn(render), exact_bilateral(sg))
            rec.gates[(d, K, sg)] = db
            rec.gate_ok[(d, K, sg)] = db >= GATE_DB
            rec.emit()

    def phase_turbo_nlm():
        ref_out = normalize(*nlm_accumulate(render, render2, nlp))
        for key in NLM_TURBO_SETTINGS:
            s_r, st, disk, hrw = key
            p = NlmParams(
                uniform_alpha=True, search_radius=s_r, search_stride=st,
                search_disk=disk, weights_halfres=hrw,
            )
            fn = lambda x, y: nlm_accumulate(x, y, p)  # noqa: E731
            rec.nlm_turbo[key] = mpix(fn, render, render2)
            db = psnr(normalize(*fn(render, render2)), ref_out)
            rec.nlm_gates[key] = db
            rec.nlm_gate_ok[key] = db >= GATE_DB
            rec.emit()

    def phase_turbo_layers():
        ref_out = normalize(*cross_bilateral_layers(render, guide, lp))
        for d in LAYERS_TURBO_DS:
            fn = lambda t, g: normalize_layers_fast(  # noqa: E731
                *cross_bilateral_layers_fast(t, g, lp, LAYERS_LEVELS, d)
            )
            rec.layers_turbo[d] = mpix(fn, render, guide)
            db = psnr(fn(render, guide), ref_out)
            rec.layers_gates[d] = db
            rec.layers_gate_ok[d] = db >= GATE_DB
            rec.emit()

    def phase_exact_1080p():
        a, b = render[:hh, :ww], render2[:hh, :ww]
        n_px = hh * ww
        rec.out["bilateral_1080p_mpix_s"] = mpix(lambda x: bilateral(x, bp), a, n_px=n_px)
        rec.out["nlm_1080p_mpix_s"] = mpix(
            lambda x, y: nlm_accumulate(x, y, nlp), a, b, n_px=n_px
        )

    def phase_temporal():
        # The reference's flagship loop (src/main.cpp:1539-1624) as its
        # device-resident rate: one frame-batched accumulate over 5 frames
        # plus normalize per output frame, exact and stride-2 disk search.
        f_n = 2 if SMOKE else 5
        tgt = render[:hh, :ww]
        frames = jnp.stack([noisy(scene, k)[:hh, :ww] for k in jax.random.split(k3, f_n)])
        for name, p in (
            ("temporal_fps_1080p", nlp),
            (
                "temporal_fps_1080p_turbo",
                NlmParams(uniform_alpha=True, search_stride=2, search_disk=True),
            ),
        ):
            fn = lambda t, fr: normalize(*nlm_accumulate_frames(t, fr, p))  # noqa: E731
            rec.out[name] = 1e3 / device_time_ms(fn, tgt, frames, reps=reps)

    def phase_exact_checks_oracle():
        # 96x128 vs the NumPy oracles (catches kernel math regressions).
        rng = np.random.default_rng(0)
        small = rng.uniform(0, 1, (96, 128, 4)).astype(np.float32)
        small2 = rng.uniform(0, 1, (96, 128, 4)).astype(np.float32)
        checks = {
            "bilateral": psnr(
                bilateral(small, BilateralParams()),
                ref.bilateral_reference(small, BilateralParams()),
            ),
            "nlm": psnr(
                normalize(*nlm_accumulate(small, small2, NlmParams())),
                ref.normalize_reference(*ref.nlm_reference(small, small2, NlmParams())),
            ),
            "layers": psnr(
                normalize(*cross_bilateral_layers(small, small2, lp)),
                ref.normalize_reference(
                    *ref.cross_bilateral_layers_reference(small, small2, lp)
                ),
            ),
        }
        for name, db in checks.items():
            if not db >= 80.0:  # oracle-exact kernels sit far above this
                rec.failures.append(f"{name}:{db:.1f}dB")

    def phase_parity():
        # The kernel in CPU-reference-params mode vs the CPU oracle, interior
        # only (the CPU path zeroes a radius-wide border, main.cpp:1823-28).
        small = np.random.default_rng(1).uniform(0, 1, (96, 128, 4)).astype(np.float32)
        cp = CpuBilateralParams()
        kp = BilateralParams(
            radius=cp.radius, sigma_spatial=cp.sigma_spatial,
            sigma_color=cp.sigma_color, blue_bug=cp.blue_bug,
        )
        got = np.asarray(bilateral(small, kp))
        want = ref.cpu_bilateral_reference(small, cp)
        r = cp.radius
        interior = (slice(r, -r), slice(r, -r), slice(0, 3))
        rec.out["psnr_parity_db"] = float(ref.psnr(got[interior], want[interior]))

    phases.run("exact_4k", phase_exact_4k, est_s=60)
    phases.run("turbo_bilateral", phase_turbo_bilateral, est_s=90)
    phases.run("turbo_nlm", phase_turbo_nlm, est_s=90)
    phases.run("turbo_layers", phase_turbo_layers, est_s=60)
    phases.run("exact_1080p", phase_exact_1080p, est_s=30)
    phases.run("temporal_fps", phase_temporal, est_s=60)
    phases.run("exact_checks_oracle", phase_exact_checks_oracle, est_s=30)
    phases.run("parity", phase_parity, est_s=30)


def main() -> None:
    rec = _Record()
    rec.emit()  # initial checkpoint
    phases = _Phases(rec)
    try:
        _measure(rec, phases)
    except Exception as e:  # noqa: BLE001 -- the record must still emit
        rec.out["error"] = f"{type(e).__name__}: {e}"[:400]
        rec.out["degraded"] = True
    finally:
        rec.emit()


if __name__ == "__main__":
    main()

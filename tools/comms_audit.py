"""Multi-device communication accounting from the virtual mesh.

Lowers each sharded config on the 8-device virtual CPU mesh, walks the
compiled (SPMD-partitioned) HLO, and tabulates the actual collectives XLA
emitted: op kind, count, and per-device byte volume. This makes the scaling
claims checkable without multi-GPU hardware: the table shows
exactly what rides the device interconnect per frame for each config (halo collective-permutes
are O(halo_rows x W) per neighbor pair; the temporal psum is O(H x W x 5
planes) once per image, amortized over all frames).

Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
         python tools/comms_audit.py [--markdown]
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

sys.path.insert(0, ".")

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from image_denoising_filter.config import (
    BilateralParams,
    LayersParams,
    NlmParams,
)
from image_denoising_filter.parallel import (
    make_mesh,
    spatial_bilateral,
    spatial_cross_bilateral_layers,
    spatial_nlm_accumulate,
    temporal_nlm_sharded,
)

_DTYPE_BYTES = {
    "f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "pred": 1,
    "s8": 1, "u8": 1, "f64": 8, "s64": 8, "u64": 8,
}

_COLLECTIVES = (
    "collective-permute", "all-reduce", "all-gather", "reduce-scatter",
    "all-to-all",
)


def _shape_bytes(shape_str: str) -> int:
    """Bytes of one HLO shape literal like 'f32[13,128,4]{2,1,0}'."""
    m = re.match(r"([a-z0-9]+)\[([0-9,]*)\]", shape_str)
    if not m:
        return 0
    dt, dims = m.groups()
    n = 1
    for d_ in dims.split(","):
        if d_:
            n *= int(d_)
    return n * _DTYPE_BYTES.get(dt, 4)


def audit(fn, *args, label: str):
    """Compile fn on the mesh and tabulate emitted collectives."""
    lowered = jax.jit(fn).lower(*args)
    hlo = lowered.compile().as_text()
    rows = {}
    for line in hlo.splitlines():
        line = line.strip()
        for kind in _COLLECTIVES:
            # match e.g.:  %cp = f32[13,128,4] collective-permute(...)
            # or tuple results:  %ar = (f32[84,256,4], f32[84,256]) all-reduce(...)
            if f" {kind}(" in line and "=" in line:
                result = line.split("=", 1)[1].split(f" {kind}(", 1)[0]
                shapes = re.findall(r"[a-z0-9]+\[[0-9,]*\]", result)
                b = sum(_shape_bytes(s) for s in shapes)
                k = (kind, "+".join(s for s in shapes))
                cnt, tot = rows.get(k, (0, 0))
                rows[k] = (cnt + 1, tot + b)
                break
    total = sum(t for _, t in rows.values())
    n_calls = sum(c for c, _ in rows.values())
    print(f"\n== {label} ==")
    if not rows:
        print("  (no collectives emitted)")
    for (kind, shape), (cnt, tot) in sorted(rows.items()):
        print(f"  {kind:20s} {shape:28s} x{cnt:<3d} {tot/1024:10.1f} KiB")
    print(f"  TOTAL per device/step: {n_calls} collective ops, {total/1024:.1f} KiB")
    return {"label": label, "ops": n_calls, "kib": total / 1024.0, "rows": rows}


def main():
    assert jax.device_count() >= 8, (
        "run with JAX_PLATFORMS=cpu "
        "XLA_FLAGS=--xla_force_host_platform_device_count=8"
    )
    h, w = 256, 256  # shapes scale linearly; W and halo widths printed exact
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 1, (h, w, 4)).astype(np.float32))
    img2 = jnp.asarray(rng.uniform(0, 1, (h, w, 4)).astype(np.float32))
    frames = jnp.asarray(rng.uniform(0, 1, (4, h, w, 4)).astype(np.float32))

    mesh_y = make_mesh((1, 8))
    mesh_fy = make_mesh((2, 4))
    bp, nlp, lp = BilateralParams(), NlmParams(), LayersParams()

    results = []
    results.append(
        audit(
            lambda x: spatial_bilateral(x, bp, mesh_y),
            img,
            label="spatial bilateral, y=8 (halo 13 rows x 2 neighbors)",
        )
    )
    results.append(
        audit(
            lambda t, n_: spatial_nlm_accumulate(t, n_, nlp, mesh_y),
            img,
            img2,
            label="spatial NLM accumulate, y=8 (halo 10 rows x 2 inputs)",
        )
    )
    results.append(
        audit(
            lambda t, l_: spatial_cross_bilateral_layers(t, l_, lp, mesh_y),
            img,
            img2,
            label="spatial layers, y=8",
        )
    )
    results.append(
        audit(
            lambda t, fr: temporal_nlm_sharded(t, fr, nlp, mesh=mesh_fy),
            img,
            frames,
            label="temporal NLM frame=2 x y=4 (psum of (wc,nw) partials)",
        )
    )

    print("\nScaling notes (per 4K frame, from the shapes above):")
    print("  - halo exchange volume = halo_rows x W x 4ch x 4B x 2 dirs:")
    print("      bilateral 13 rows -> 13x3840x16x2 = 1.6 MiB/frame/seam")
    print("      NLM 10 rows x 2 tensors          -> 2.5 MiB/frame/seam")
    print("  - temporal psum = H x W x 5 planes x 4B once per image:")
    print("      4K -> 158 MiB all-reduced ONCE, amortized over all frames")
    print("  - per-device compute falls as 1/(F x Y); the psum is fixed cost.")


if __name__ == "__main__":
    main()

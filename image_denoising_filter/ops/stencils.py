"""GPU stencil kernels (Pallas, Triton route): bilateral, layer-guided
cross-bilateral and NLM accumulation.

These are the tiled-layout versions of the reference's compute shaders
(shaders/bialteral.comp, bialteral_layers.comp, nonlocal.comp), shaped like
the original Vulkan design rather than like a whole-image XLA graph:

  * one program per (bh, bw) output block -- the 16x16 workgroup's analogue,
    with power-of-two block sides as Triton requires;
  * every stencil tap is a load of a (bh, bw) tile from the pre-padded planar
    image at a shifted offset; neighbouring taps hit the same lines, so they
    are served by L1 (the texture cache's analogue);
  * the weight accumulators stay in registers for the whole tap walk, and
    for temporal NLM the frame loop runs inside the program, so the weights
    never round-trip through HBM (the reference's persistent weights buffer,
    src/main.cpp:1430-1433);
  * the spatial and colour Gaussians fuse into a single exp2 per tap, with
    log2(e) folded into the compile-time constants.

Images are handled planar (C, H, W) float32, pre-padded per the border policy
so in-kernel indexing is branch-free; outputs are allocated at whole blocks and
cropped, so no store is ever out of bounds. The "linear" layout variant lives
in ops/xla.py and is the plain reference these kernels are compared with.

All public functions take/return (H, W, 4) float32 arrays (transposed
internally) so they are drop-in interchangeable with ops/reference.py and
ops/xla.py.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..config import (
    BilateralParams,
    BorderPolicy,
    LayersParams,
    NlmParams,
    TilingConfig,
)
from . import xla as ops_xla

# Output block (block_h, block_w) and warps of one program, for both kernel
# families: a sweep on the card put (16, 64) with 4 warps within 4% of the
# best block for each.
BLOCK = (16, 64)
NUM_WARPS = 4

# exp(x) == exp2(x * log2(e)): folding log2(e) into the (compile-time) weight
# constants turns every per-tap exp into a bare exp2.
LOG2E = float(np.log2(np.e))


def interpret_mode() -> bool:
    """The dispatch rule for every Pallas kernel in this package: the GPU
    backend compiles the kernel for the card, the CPU backend runs it in
    Pallas interpret mode (tests), and any other backend is refused -- there
    is no silent fallback."""
    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise RuntimeError(f"no stencil kernel for the {backend!r} backend")


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _block(h: int, w: int, tiling: Optional[TilingConfig]) -> tuple[int, int]:
    """(block_h, block_w): the tiling override or BLOCK, with each side
    shrunk to the image (still a power of two)."""
    bh, bw = BLOCK
    if tiling is not None:
        bh = tiling.tile_h or bh
        bw = tiling.tile_w or bw
    for side in (bh, bw):
        if side <= 0 or side & (side - 1):
            raise ValueError(f"block sides must be powers of two, got {bh}x{bw}")
    return min(bh, _next_pow2(h)), min(bw, _next_pow2(w))


def _to_planar(img: jnp.ndarray) -> jnp.ndarray:
    return jnp.transpose(img.astype(jnp.float32), (2, 0, 1))


def _from_planar(img: jnp.ndarray) -> jnp.ndarray:
    return jnp.transpose(img, (1, 2, 0))


def _pad_planar(
    img: jnp.ndarray, halo: int, border: str, rows: int, cols: int
) -> jnp.ndarray:
    """Pad the last two axes of (..., H, W) to (rows, cols) with `halo` on the
    leading edges, per the border policy (edge replication == CLAMP taps)."""
    h, w = img.shape[-2:]
    widths = ((0, 0),) * (img.ndim - 2) + (
        (halo, rows - h - halo),
        (halo, cols - w - halo),
    )
    mode = "edge" if border == BorderPolicy.CLAMP else "constant"
    return jnp.pad(img, widths, mode=mode)


def _load(ref, *idx):
    return plt.load(ref.at[idx])


# ---------------------------------------------------------------------------
# Bilateral (shaders/bialteral.comp) -- also the weight engine for the
# layer-guided variant (shaders/bialteral_layers.comp) via `guide`.
# ---------------------------------------------------------------------------


def disk_half_widths(
    radius: int, sigma_spatial: float, truncate_eps: float
) -> np.ndarray:
    """Per-row dx half-widths (int32, rows dy = -radius..radius) of the exact
    truncation DISK {dy^2 + dx^2 <= R^2}, R^2 = 2 ss^2 ln(1/eps).

    Spatial-weight truncation is tap-exact: a tap contributes
    w = exp(-0.5 (dy^2+dx^2)/ss^2) * w_color with w_color <= 1, so any tap
    with spatial weight < truncate_eps cannot move the float32-normalized
    output (BilateralParams.truncate_eps). The disk is ~pi/4 of the square
    window the reference iterates (shaders/bialteral.comp:51-53) -- ~465 vs
    41x41=1681 taps at the reference sigma_s=2.0. `radius` is the
    effective radius, so every row keeps at least its centre tap."""
    if truncate_eps > 0.0:
        r2_max = 2.0 * sigma_spatial * sigma_spatial * math.log(1.0 / truncate_eps)
    else:
        r2_max = float("inf")
    dy = np.arange(-radius, radius + 1)
    hw = np.floor(np.sqrt(np.maximum(r2_max - dy * dy, 0.0)))
    return np.minimum(hw, radius).astype(np.int32)


def _bilateral_kernel(
    hw_ref,
    img_ref,
    guide_ref,
    wc_ref,
    nw_ref,
    *,
    radius: int,
    bh: int,
    bw: int,
    inv_ss2: float,
    inv2sc: float,
    blue_bug: bool,
    guided: bool,
    fuse_normalize: bool,
    uniform_alpha: bool,
):
    """Disk-masked tap walk for one (bh, bw) output block: a loop over the
    disk's rows and, inside it, over that row's columns (both dynamic, so the
    kernel stays small and compiles in seconds), each tap a shifted load."""
    y0 = pl.program_id(0) * bh + radius  # padded row of output row 0
    x0 = pl.program_id(1) * bw + radius
    src = guide_ref if guided else img_ref

    def tap(ref, c, dy, dx):
        return _load(ref, c, pl.ds(y0 + dy, bh), pl.ds(x0 + dx, bw))

    center = [tap(src, c, 0, 0) for c in range(3)]
    n_acc = 3 if uniform_alpha else 4
    zero = jnp.zeros((bh, bw), jnp.float32)
    ks = jnp.float32(-0.5 * inv_ss2 * LOG2E)
    kc = jnp.float32(inv2sc * LOG2E)

    def row_body(r, accs):
        dy = r - radius
        hw = hw_ref[r]
        fy = dy.astype(jnp.float32)
        row_term = ks * fy * fy

        def col_body(cx, accs):
            dx = cx - hw
            fx = dx.astype(jnp.float32)
            g = [tap(src, c, dy, dx) for c in range(3)]
            d0 = center[0] - g[0]
            d1 = center[1] - g[1]
            ssd = d0 * d0 + d1 * d1
            if not blue_bug:
                d2 = center[2] - g[2]
                ssd = ssd + d2 * d2
            wgt = jnp.exp2((row_term + ks * fx * fx) - ssd * kc)
            if guided:
                vals = [tap(img_ref, c, dy, dx) for c in range(n_acc)]
            else:
                vals = g + ([tap(img_ref, 3, dy, dx)] if n_acc == 4 else [])
            return (
                *(accs[c] + vals[c] * wgt for c in range(n_acc)),
                accs[n_acc] + wgt,
            )

        return jax.lax.fori_loop(0, 2 * hw + 1, col_body, accs)

    accs = jax.lax.fori_loop(0, 2 * radius + 1, row_body, (zero,) * (n_acc + 1))
    nw = accs[n_acc]
    wc = list(accs[:n_acc])
    if uniform_alpha:
        # sum(w * a) == a * sum(w) when alpha is one constant everywhere.
        wc.append(tap(img_ref, 3, 0, 0) * nw)
    if fuse_normalize:
        wc = [v / nw for v in wc]
    for c in range(4):
        wc_ref[c, :, :] = wc[c]
    nw_ref[...] = nw


def _bilateral_planar(
    img: jnp.ndarray,
    guide: Optional[jnp.ndarray],
    params: BilateralParams,
    tiling: Optional[TilingConfig],
    fuse_normalize: bool,
):
    _, h, w = img.shape
    # Spatial-weight truncation: taps beyond effective_radius have weight
    # < truncate_eps and cannot change the float32 output (config.py).
    r = params.effective_radius
    bh, bw = _block(h, w, tiling)
    gh, gw = pl.cdiv(h, bh), pl.cdiv(w, bw)
    rows, cols = gh * bh + 2 * r, gw * bw + 2 * r
    guided = guide is not None
    padded = _pad_planar(img, r, params.border, rows, cols)
    padded_g = (
        _pad_planar(guide[:3], r, params.border, rows, cols) if guided else padded
    )
    kernel = functools.partial(
        _bilateral_kernel,
        radius=r,
        bh=bh,
        bw=bw,
        inv_ss2=1.0 / (params.sigma_spatial**2),
        inv2sc=0.5 / (params.sigma_color**2),
        blue_bug=params.blue_bug,
        guided=guided,
        fuse_normalize=fuse_normalize,
        uniform_alpha=params.uniform_alpha,
    )
    wc, nw = pl.pallas_call(
        kernel,
        grid=(gh, gw),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 3,
        out_specs=[
            pl.BlockSpec((4, bh, bw), lambda i, j: (0, i, j)),
            pl.BlockSpec((bh, bw), lambda i, j: (i, j)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((4, gh * bh, gw * bw), jnp.float32),
            jax.ShapeDtypeStruct((gh * bh, gw * bw), jnp.float32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret_mode(),
        name="cross_bilateral" if guided else "bilateral",
    )(
        jnp.asarray(disk_half_widths(r, params.sigma_spatial, params.truncate_eps)),
        padded,
        padded_g,
    )
    return wc[:, :h, :w], nw[:h, :w]


@functools.partial(jax.jit, static_argnums=(1, 2))
def bilateral(
    img: jnp.ndarray,
    params: BilateralParams = BilateralParams(),
    tiling: Optional[TilingConfig] = None,
) -> jnp.ndarray:
    """Bilateral filter, tiled-layout GPU kernel (shaders/bialteral.comp).

    img: (H, W, 4) float32. Returns the filtered (H, W, 4) image (the
    normalization is fused -- the reference's plain-bilateral path also
    normalizes in-kernel, bialteral.comp:72).
    """
    out, _ = _bilateral_planar(_to_planar(img), None, params, tiling, True)
    return _from_planar(out)


@functools.partial(jax.jit, static_argnums=(2, 3))
def cross_bilateral_layers(
    target: jnp.ndarray,
    layer: jnp.ndarray,
    params: LayersParams = LayersParams(),
    tiling: Optional[TilingConfig] = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One layer's cross-bilateral accumulation partials
    (shaders/bialteral_layers.comp): weights from `layer` (the G-buffer guide),
    colors from `target`. Returns (weightColor (H,W,4), normWeight (H,W))."""
    wc, nw = _bilateral_planar(
        _to_planar(target), _to_planar(layer), params, tiling, False
    )
    return _from_planar(wc), nw


# ---------------------------------------------------------------------------
# Non-local means (shaders/nonlocal.comp)
# ---------------------------------------------------------------------------


def nlm_candidates(params: NlmParams) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The search offsets the kernel walks: (dy, dx) int32 displacements in
    [-s, s) x [-s, s) (shaders/nonlocal.comp:36-38) and each one's log2
    weight bias.

    search_stride > 1 keeps every stride-th offset per axis, phase-aligned so
    the zero offset (the SSD-0 self-match) is kept, and compensates the
    dropped offsets by weighting every non-self offset stride^2 (a log2 bias,
    zero extra arithmetic); search_disk drops the grid's corners
    (config.NlmParams). Same subset as ops/xla.py:nlm_xla."""
    s, st = params.search_radius, params.search_stride
    d = np.arange(s % st, 2 * s, st) - s
    dy, dx = (a.ravel() for a in np.meshgrid(d, d, indexing="ij"))
    if params.search_disk:
        keep = dy * dy + dx * dx <= s * s
        dy, dx = dy[keep], dx[keep]
    bias = np.where(
        (dy == 0) & (dx == 0) | (st == 1), 0.0, np.log2(float(st * st))
    )
    return dy.astype(np.int32), dx.astype(np.int32), bias.astype(np.float32)


def _nlm_kernel(
    dy_ref,
    dx_ref,
    bias_ref,
    valid_ref,
    tgt_ref,
    nbr_ref,
    wc_ref,
    nw_ref,
    e_ref,
    hs_ref,
    *,
    n_cand: int,
    n_frames: int,
    p: int,
    halo: int,
    bh: int,
    bw: int,
    pe: int,
    inv_h2: float,
    norm_seed: float,
    uniform_alpha: bool,
    sync: bool,
):
    """Frame-batched NLM accumulation for one (bh, bw) output block.

    For each search offset d the patch SSD is the 2p x 2p box sum of the
    per-pixel squared difference E_d (the offset decomposition -- identical
    math to the reference's quadruple loop, ~10x fewer flops). Registers
    cannot be shifted, so E_d is written to this program's private scratch
    tile (e_ref), box-summed along rows into a second one (hs_ref) and then
    along columns, each pass re-reading shifted windows through L1; block
    barriers order the passes. The frame loop and the offset loop both run
    inside the program, so (weightColor, normWeight) stay in registers across
    all frames."""
    i, j = pl.program_id(0), pl.program_id(1)
    pid = i * pl.num_programs(1) + j
    y0 = i * bh + halo  # padded row of output row 0
    x0 = j * bw + halo
    # E covers output-relative rows/cols [-p, b + p - 1): a (b, b) tile plus
    # pe-wide strips, so every piece has power-of-two sides.
    pieces = ((0, 0, bh, bw), (0, bw, bh, pe), (bh, 0, pe, bw), (bh, bw, pe, pe))
    tgt = [
        [
            _load(tgt_ref, c, pl.ds(y0 - p + er, nr), pl.ds(x0 - p + ec, nc))
            for c in range(3)
        ]
        for er, ec, nr, nc in pieces
    ]
    kh = jnp.float32(-inv_h2 * LOG2E)
    n_taps = 3 if uniform_alpha else 4

    def barrier():
        if sync:  # interpret mode runs programs one at a time
            plt.debug_barrier()

    def frame_body(f, acc):
        v = valid_ref[f]

        def cand_body(k, carry):
            wc = list(carry[:n_taps])
            nwf = carry[n_taps]
            dy, dx = dy_ref[k], dx_ref[k]
            for (er, ec, nr, nc), t in zip(pieces, tgt):
                e = None
                for c in range(3):
                    n = _load(
                        nbr_ref,
                        f,
                        c,
                        pl.ds(y0 - p + er + dy, nr),
                        pl.ds(x0 - p + ec + dx, nc),
                    )
                    dd = t[c] - n
                    e = dd * dd if e is None else e + dd * dd
                plt.store(e_ref.at[pid, pl.ds(er, nr), pl.ds(ec, nc)], e)
            barrier()
            for er, nr in ((0, bh), (bh, pe)):
                row_box = None
                for jx in range(2 * p):
                    x = _load(e_ref, pid, pl.ds(er, nr), pl.ds(jx, bw))
                    row_box = x if row_box is None else row_box + x
                plt.store(hs_ref.at[pid, pl.ds(er, nr), :], row_box)
            barrier()
            ssd = None
            for jy in range(2 * p):
                x = _load(hs_ref, pid, pl.ds(jy, bh), slice(None))
                ssd = x if ssd is None else ssd + x
            barrier()  # the next offset overwrites both scratch tiles
            wgt = jnp.exp2(ssd * kh + bias_ref[k]) * v
            for c in range(n_taps):
                tap = _load(nbr_ref, f, c, pl.ds(y0 + dy, bh), pl.ds(x0 + dx, bw))
                wc[c] = wc[c] + tap * wgt
            return (*wc, nwf + wgt)

        zero = jnp.zeros((bh, bw), jnp.float32)
        out = jax.lax.fori_loop(0, n_cand, cand_body, (*acc[:n_taps], zero))
        wc, nwf = list(out[:n_taps]), out[n_taps]
        wc3 = acc[3]
        if uniform_alpha:
            # This frame's tap alphas are one constant a: sum(w * a) = a *
            # sum(w); the seed is not alpha-weighted (shaders/nonlocal.comp:
            # 32, 61). Reconstructed per frame, so frames with different
            # constants stay exact.
            alpha = _load(nbr_ref, f, 3, pl.ds(y0, bh), pl.ds(x0, bw))
            wc3 = wc3 + alpha * nwf
        else:
            wc3 = wc[3]
        # Each valid frame seeds the norm once (shaders/nonlocal.comp:32).
        return (wc[0], wc[1], wc[2], wc3, acc[4] + nwf + v * norm_seed)

    zero = jnp.zeros((bh, bw), jnp.float32)
    acc = jax.lax.fori_loop(0, n_frames, frame_body, (zero,) * 5)
    for c in range(4):
        wc_ref[c, :, :] = acc[c]
    nw_ref[...] = acc[4]


def _nlm_planar_frames(
    tgt: jnp.ndarray,  # (4, H, W)
    frames: jnp.ndarray,  # (F, 4, H, W)
    params: NlmParams,
    tiling: Optional[TilingConfig],
    valid: jnp.ndarray,  # (F,) float 0/1 frame mask
) -> tuple[jnp.ndarray, jnp.ndarray]:
    _, h, w = tgt.shape
    n_frames = frames.shape[0]
    s, p = params.search_radius, params.patch_radius
    halo = s + p
    bh, bw = _block(h, w, tiling)
    gh, gw = pl.cdiv(h, bh), pl.cdiv(w, bw)
    pe = max(2, _next_pow2(2 * p - 1))  # E strip width, >= 2p - 1
    rows, cols = gh * bh + 2 * halo + pe, gw * bw + 2 * halo + pe
    padded_t = _pad_planar(tgt[:3], halo, params.border, rows, cols)
    padded_n = _pad_planar(frames, halo, params.border, rows, cols)
    dy, dx, bias = nlm_candidates(params)
    kernel = functools.partial(
        _nlm_kernel,
        n_cand=len(dy),
        n_frames=n_frames,
        p=p,
        halo=halo,
        bh=bh,
        bw=bw,
        pe=pe,
        inv_h2=1.0 / (params.h**2),
        norm_seed=params.norm_seed,
        uniform_alpha=params.uniform_alpha,
        sync=not interpret_mode(),
    )
    wc, nw, _, _ = pl.pallas_call(
        kernel,
        grid=(gh, gw),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 6,
        out_specs=[
            pl.BlockSpec((4, bh, bw), lambda i, j: (0, i, j)),
            pl.BlockSpec((bh, bw), lambda i, j: (i, j)),
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((4, gh * bh, gw * bw), jnp.float32),
            jax.ShapeDtypeStruct((gh * bh, gw * bw), jnp.float32),
            # Per-program scratch tiles (E_d and its row box sums).
            jax.ShapeDtypeStruct((gh * gw, bh + pe, bw + pe), jnp.float32),
            jax.ShapeDtypeStruct((gh * gw, bh + pe, bw), jnp.float32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret_mode(),
        name="nlm_accumulate",
    )(
        jnp.asarray(dy),
        jnp.asarray(dx),
        jnp.asarray(bias),
        valid.astype(jnp.float32),
        padded_t,
        padded_n,
    )
    return wc[:, :h, :w], nw[:h, :w]


def _nlm_halfres_frames(target, frames, params, valid):
    """weights_halfres has no hand kernel: per-frame XLA partials."""

    def body(carry, fv):
        frame, v = fv
        pwc, pnw = ops_xla.nlm_xla(target, frame, params)
        return (carry[0] + pwc * v, carry[1] + pnw * v), None

    h, w, _ = target.shape
    init = (jnp.zeros((h, w, 4), jnp.float32), jnp.zeros((h, w), jnp.float32))
    (wc, nw), _ = jax.lax.scan(body, init, (frames, valid.astype(jnp.float32)))
    return wc, nw


@functools.partial(jax.jit, static_argnums=(2, 3))
def nlm_accumulate(
    target: jnp.ndarray,
    neighbour: jnp.ndarray,
    params: NlmParams = NlmParams(),
    tiling: Optional[TilingConfig] = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One frame's NLM accumulation (shaders/nonlocal.comp:30-65).

    Returns (weightColor (H,W,4), normWeight (H,W)); normWeight is seeded with
    params.norm_seed for this frame (nonlocal.comp:32). Sum partials across
    frames and finish with normalize() for temporal multiframe NLM (or use
    nlm_accumulate_frames, which keeps the accumulators in registers).
    """
    return nlm_accumulate_frames(target, neighbour[None], params, tiling)


@functools.partial(jax.jit, static_argnums=(2, 3))
def nlm_accumulate_frames(
    target: jnp.ndarray,
    frames: jnp.ndarray,
    params: NlmParams = NlmParams(),
    tiling: Optional[TilingConfig] = None,
    valid: Optional[jnp.ndarray] = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Temporal NLM accumulation over a stacked (F, H, W, 4) frame batch in ONE
    kernel launch: the frame loop runs inside each program, so the weight
    accumulators stay in registers across frames like the reference's
    persistent weights buffer (src/main.cpp:1430-1433). Each frame contributes
    its norm seed (shaders/nonlocal.comp:32); finish with normalize().
    `valid` ((F,) float 0/1) masks padding frames: a masked frame contributes
    neither weights nor its seed."""
    if valid is None:
        valid = jnp.ones((frames.shape[0],), jnp.float32)
    if params.weights_halfres:
        return _nlm_halfres_frames(target, frames, params, valid)
    wc, nw = _nlm_planar_frames(
        _to_planar(target),
        jnp.transpose(frames.astype(jnp.float32), (0, 3, 1, 2)),
        params,
        tiling,
        valid,
    )
    return _from_planar(wc), nw

"""Spatial (row) sharding with halo exchange, and frame-level DP.

The stencil analog of sequence parallelism: the image's H axis is sharded over
the mesh's 'y' axis; each shard needs `halo` rows from its neighbors before
filtering (the ring-attention-style neighbor exchange, SURVEY.md section 5).
Halo strips move with `jax.lax.ppermute` (XLA lowers these to
collective-permutes, over NVLink between GPUs); the outermost shards
synthesize their missing halo per the border policy (clamp-edge replication /
zeros).

Each shard then runs the *local* stencil kernel on its (halo + rows + halo)
extension and crops the center back out -- provably identical to filtering the
unsharded image, which tests/test_sharding.py asserts against the oracles.

Temporal NLM adds frame-level data parallelism: frames are sharded over the
'frame' mesh axis, each device accumulates partials for its local frames, and
a `psum` over 'frame' reduces the (weightColor, normWeight) accumulators --
the multi-chip form of the reference's weights-buffer `+=` across dispatches
(shaders/nonlocal.comp:61-62).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import (
    BilateralParams,
    BorderPolicy,
    LayersParams,
    NlmParams,
    NormalizeParams,
    TilingConfig,
)
from .. import ops
from ..ops import xla as ops_xla
from .mesh import FRAME_AXIS, SPATIAL_AXIS


def _exchange_halo(
    local: jnp.ndarray, halo: int, border: str, axis: str, row_axis: int = 0
) -> jnp.ndarray:
    """Extend a row-shard with `halo` rows from each neighbor.

    local: this shard's rows, with the image's H axis at `row_axis` (0 for
    the channel-last (rows, W, 4) layout, 1 for planar (C, rows, W)). Returns
    the input extended by `halo` rows on each side of `row_axis`.
    """
    n = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)
    rows = local.shape[row_axis]
    if rows < halo:
        raise ValueError(
            f"spatial shard has {rows} rows but the stencil needs a "
            f"{halo}-row halo; use fewer 'y' shards or pad rows "
            "(runtime.Session does this automatically)"
        )

    def rows_slice(start, size):
        return jax.lax.slice_in_dim(local, start, start + size, axis=row_axis)

    # Shard i's top halo is the *bottom* rows of shard i-1; its bottom halo is
    # the top rows of shard i+1.
    bottom_rows = rows_slice(rows - halo, halo)
    top_rows = rows_slice(0, halo)
    from_above = jax.lax.ppermute(
        bottom_rows, axis, [(i, i + 1) for i in range(n - 1)]
    )
    from_below = jax.lax.ppermute(
        top_rows, axis, [(i + 1, i) for i in range(n - 1)]
    )

    if border == BorderPolicy.CLAMP:
        edge_top = jnp.repeat(rows_slice(0, 1), halo, axis=row_axis)
        edge_bottom = jnp.repeat(rows_slice(rows - 1, 1), halo, axis=row_axis)
    else:
        edge_top = jnp.zeros_like(top_rows)
        edge_bottom = jnp.zeros_like(bottom_rows)

    top = jnp.where(idx == 0, edge_top, from_above)
    bottom = jnp.where(idx == n - 1, edge_bottom, from_below)
    return jnp.concatenate([top, local, bottom], axis=row_axis)


def _row_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(None, SPATIAL_AXIS))


def _split_halo_compute(locals_, halo: int, border: str, axis: str, fn):
    """Compute-communication overlap for a row-sharded stencil.

    Issues the ppermute halo exchanges FIRST, then computes the shard interior
    (which depends only on local rows), then the two edge strips (which consume
    the ppermute results). XLA's latency-hiding scheduler can run the
    collectives under the interior kernel because nothing in it depends on
    them -- the stencil analog of overlapping ring-attention's neighbor
    passing with block compute.

    locals_: tuple of (rows, W, C...) local shards sharing the row count.
    fn: maps a tuple of row-extended arrays to a tuple of outputs whose leading
    axis aligns with its inputs' rows. Returns the outputs cropped/stitched to
    `rows`. Falls back to the blocking exchange when shards are too short for
    a meaningful interior (rows < 3*halo).
    """
    rows = locals_[0].shape[0]
    n = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)

    if rows < 3 * halo or n == 1:
        exts = tuple(_exchange_halo(x, halo, border, axis) for x in locals_)
        outs = fn(exts)
        return tuple(o[halo : halo + rows] for o in outs)

    aboves, belows = [], []
    for x in locals_:  # issue all exchanges up front (async under interior)
        from_above = jax.lax.ppermute(
            x[-halo:], axis, [(i, i + 1) for i in range(n - 1)]
        )
        from_below = jax.lax.ppermute(
            x[:halo], axis, [(i + 1, i) for i in range(n - 1)]
        )
        if border == BorderPolicy.CLAMP:
            edge_top = jnp.repeat(x[:1], halo, axis=0)
            edge_bottom = jnp.repeat(x[-1:], halo, axis=0)
        else:
            edge_top = jnp.zeros_like(x[:halo])
            edge_bottom = jnp.zeros_like(x[-halo:])
        aboves.append(jnp.where(idx == 0, edge_top, from_above))
        belows.append(jnp.where(idx == n - 1, edge_bottom, from_below))

    # Interior: output rows [halo, rows-halo) depend on input rows [0, rows)
    # only -- fn's own border padding influences just its first/last halo
    # output rows, which are discarded.
    int_outs = fn(locals_)
    # Top edge: output rows [0, halo) need input rows [-halo, 2*halo).
    top_outs = fn(tuple(
        jnp.concatenate([a, x[: 2 * halo]], axis=0)
        for a, x in zip(aboves, locals_)
    ))
    # Bottom edge: output rows [rows-halo, rows) need [rows-2*halo, rows+halo).
    bot_outs = fn(tuple(
        jnp.concatenate([x[-2 * halo :], b], axis=0)
        for b, x in zip(belows, locals_)
    ))
    return tuple(
        jnp.concatenate(
            [t[halo : 2 * halo], i[halo : rows - halo], b[halo : 2 * halo]],
            axis=0,
        )
        for t, i, b in zip(top_outs, int_outs, bot_outs)
    )


def spatial_bilateral(
    img: jnp.ndarray,
    params: BilateralParams = BilateralParams(),
    mesh: Optional[Mesh] = None,
    tiling: Optional[TilingConfig] = None,
    linear: bool = False,
) -> jnp.ndarray:
    """Bilateral filter with H sharded over the mesh's 'y' axis.

    img: (H, W, 4) with H divisible by the 'y' axis size. The local kernel runs
    on the halo-extended shard and the center is cropped back -- identical
    output to the single-device kernel. linear=True shards the XLA
    linear-layout variant instead of the tiled GPU kernel.
    """
    halo = params.effective_radius  # what the kernel actually reads

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        check_vma=False,  # pallas_call outputs don't carry vma metadata
        in_specs=P(SPATIAL_AXIS, None, None),
        out_specs=P(SPATIAL_AXIS, None, None),
    )
    def run(local):
        def fn(exts):
            (ext,) = exts
            if linear:
                return (ops_xla.bilateral_xla(ext, params),)
            return (ops.bilateral(ext, params, tiling),)

        (out,) = _split_halo_compute(
            (local,), halo, params.border, SPATIAL_AXIS, fn
        )
        return out

    return run(img)


def _check_hrw_lattice(params: NlmParams, h: int, mesh: Mesh) -> None:
    """Refuse mesh shapes that would silently SHIFT the half-row pooling
    lattice: the weights_halfres path (ops/xla.py:nlm_xla) pools row pairs
    from the start of its input, so a shard whose halo-extended block starts
    on an ODD global row computes a one-row-shifted (still valid, but
    different and untested) approximation vs single-device. Every shard starts at idx*rows - halo;
    all starts are even iff rows-per-shard AND the halo (s + p) are both
    even. The reference params (s=7, p=3: halo 10) pass for any even
    per-shard height (4K/8 shards: 270). Raising beats a silent per-mesh
    approximation change; use weights_halfres=False (full-res weights) or an
    even row partition instead."""
    if not params.weights_halfres or mesh is None:
        return
    n = mesh.shape.get(SPATIAL_AXIS, 1)
    if n <= 1:
        return
    rows = h // n
    halo = params.search_radius + params.patch_radius
    if rows % 2 != 0 or halo % 2 != 0:
        raise ValueError(
            "weights_halfres sharding needs every shard to start on the "
            f"even-row pooling lattice: rows/shard={rows} and halo "
            f"(search_radius+patch_radius)={halo} must both be even, or the "
            "per-shard lattice silently shifts vs single-device. Use an "
            "even row partition or weights_halfres=False."
        )


def spatial_nlm_accumulate(
    target: jnp.ndarray,
    neighbour: jnp.ndarray,
    params: NlmParams = NlmParams(),
    mesh: Optional[Mesh] = None,
    tiling: Optional[TilingConfig] = None,
    linear: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One frame's NLM partials with H sharded over 'y'."""
    halo = params.search_radius + params.patch_radius
    _check_hrw_lattice(params, target.shape[0], mesh)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        check_vma=False,  # pallas_call outputs don't carry vma metadata
        in_specs=(P(SPATIAL_AXIS, None, None), P(SPATIAL_AXIS, None, None)),
        out_specs=(P(SPATIAL_AXIS, None, None), P(SPATIAL_AXIS, None)),
    )
    def run(t_local, n_local):
        def fn(exts):
            if linear:
                return ops_xla.nlm_xla(exts[0], exts[1], params)
            return ops.nlm_accumulate(exts[0], exts[1], params, tiling)

        return _split_halo_compute(
            (t_local, n_local), halo, params.border, SPATIAL_AXIS, fn
        )

    return run(target, neighbour)


def spatial_cross_bilateral_layers(
    target: jnp.ndarray,
    layer: jnp.ndarray,
    params: LayersParams = LayersParams(),
    mesh: Optional[Mesh] = None,
    tiling: Optional[TilingConfig] = None,
    linear: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One layer's cross-bilateral partials with H sharded over 'y'."""
    halo = params.effective_radius

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        check_vma=False,  # pallas_call outputs don't carry vma metadata
        in_specs=(P(SPATIAL_AXIS, None, None), P(SPATIAL_AXIS, None, None)),
        out_specs=(P(SPATIAL_AXIS, None, None), P(SPATIAL_AXIS, None)),
    )
    def run(t_local, l_local):
        def fn(exts):
            if linear:
                return ops_xla.cross_bilateral_layers_xla(exts[0], exts[1], params)
            return ops.cross_bilateral_layers(exts[0], exts[1], params, tiling)

        return _split_halo_compute(
            (t_local, l_local), halo, params.border, SPATIAL_AXIS, fn
        )

    return run(target, layer)


def temporal_nlm_sharded_partials(
    target: jnp.ndarray,
    frames: jnp.ndarray,
    params: NlmParams = NlmParams(),
    mesh: Optional[Mesh] = None,
    tiling: Optional[TilingConfig] = None,
    valid: Optional[jnp.ndarray] = None,
    linear: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Weight partials of multichip temporal NLM over one frame batch: frames
    sharded over 'frame' (DP), rows over 'y' (spatial), partials psum'd over
    'frame'. Returns ((H, W, 4), (H, W)) row-sharded accumulators; sum across
    batches and normalize() to finish. `valid` ((F,) float 0/1) masks padding
    frames: a masked frame contributes neither weights nor its norm seed."""
    halo = params.search_radius + params.patch_radius
    _check_hrw_lattice(params, target.shape[0], mesh)
    # Each frame contributes norm_seed once (shaders/nonlocal.comp:32); the
    # per-device kernel seeds its local frames, and psum adds them up -- same
    # total seed F * norm_seed as the sequential reference loop.

    if valid is None:
        valid = jnp.ones((frames.shape[0],), jnp.float32)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        check_vma=False,  # pallas_call outputs don't carry vma metadata
        in_specs=(
            P(SPATIAL_AXIS, None, None),
            P(FRAME_AXIS, SPATIAL_AXIS, None, None),
            P(FRAME_AXIS),
        ),
        out_specs=(P(SPATIAL_AXIS, None, None), P(SPATIAL_AXIS, None)),
    )
    def run(t_local, frames_local, valid_local):
        rows = t_local.shape[0]
        t_ext = _exchange_halo(t_local, halo, params.border, SPATIAL_AXIS)
        if linear:
            # XLA variant has no frame-batched kernel: per-frame scan, with
            # the halo exchange INSIDE the scan body so only one halo-extended
            # frame is live at a time (materializing the whole stacked f_ext
            # up front would roughly double per-device frame memory on long
            # 4K chunks; the frame-batched kernel branch below genuinely
            # needs the stacked array).
            def body(carry, frame_and_valid):
                frame, v = frame_and_valid
                f_ext = _exchange_halo(
                    frame, halo, params.border, SPATIAL_AXIS
                )
                wc_c, nw_c = carry
                pwc, pnw = ops_xla.nlm_xla(t_ext, f_ext, params)
                return (wc_c + pwc * v, nw_c + pnw * v), None

            ext_rows = rows + 2 * halo
            init = (
                jnp.zeros((ext_rows, t_local.shape[1], 4), jnp.float32),
                jnp.zeros((ext_rows, t_local.shape[1]), jnp.float32),
            )
            (wc, nw), _ = jax.lax.scan(body, init, (frames_local, valid_local))
        else:
            f_ext = jax.vmap(
                lambda fr: _exchange_halo(fr, halo, params.border, SPATIAL_AXIS)
            )(frames_local)
            # Frame-batched kernel over the device's local frame chunk: the
            # (wc, nw) accumulators stay in registers across the frames (the
            # reference's persistent weights buffer, src/main.cpp:1430-1433)
            # instead of a per-frame HBM round-trip of the partials. `valid`
            # masks padding frames in-kernel.
            wc, nw = ops.nlm_accumulate_frames(
                t_ext, f_ext, params, tiling, valid_local
            )
        wc = jax.lax.psum(wc, FRAME_AXIS)
        nw = jax.lax.psum(nw, FRAME_AXIS)
        return wc[halo : halo + rows], nw[halo : halo + rows]

    return run(target, frames, valid)


def temporal_nlm_sharded(
    target: jnp.ndarray,
    frames: jnp.ndarray,
    params: NlmParams = NlmParams(),
    norm_params: NormalizeParams = NormalizeParams(),
    mesh: Optional[Mesh] = None,
    tiling: Optional[TilingConfig] = None,
    valid: Optional[jnp.ndarray] = None,
    linear: bool = False,
) -> jnp.ndarray:
    """Full multichip temporal NLM in one shot: partials over the whole frame
    stack, then normalize. target: (H, W, 4); frames: (F, H, W, 4) with F
    divisible by the 'frame' axis size and H by the 'y' axis size. For
    streamed upload of long frame sequences, see Session._run_sharded, which
    feeds temporal_nlm_sharded_partials chunk by chunk with the next chunk's
    host->HBM transfer in flight under the current chunk's kernels."""
    wc, nw = temporal_nlm_sharded_partials(
        target, frames, params, mesh, tiling, valid, linear
    )
    # Pointwise epilogue: GSPMD partitions it along the existing row sharding.
    return ops.normalize(wc, nw, norm_params)

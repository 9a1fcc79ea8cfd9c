"""Denoiser model families: the config battery of the reference as composable,
jit-compiled pipeline models.

The reference's six GPU configurations (src/main.cpp:1953-1973) map to four
model families here:

  * BilateralDenoiser        -- plain bilateral, tiled (GPU kernel) or linear (XLA)
                                layout (bialteral.comp / bialteral_linear.comp)
  * LayerGuidedDenoiser      -- cross-bilateral over G-buffer layers with
                                accumulate+normalize (bialteral_layers.comp +
                                normalize.comp)
  * NlmDenoiser              -- single-frame non-local means (nonlocal.comp +
                                normalize.comp, target bound as both images,
                                src/main.cpp:1521-1528)
  * TemporalNlmDenoiser      -- multiframe NLM: weight partials accumulated
                                over neighbor frames then normalized
                                (src/main.cpp:1554-1624, 1649-1652)

All models consume/produce (H, W, 4) float32 RGBA and are jit-friendly; the
frame/layer loops run as XLA scans over stacked arrays so the whole pipeline is
one compiled computation per shape.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import (
    BilateralParams,
    LayersParams,
    NlmParams,
    NormalizeParams,
    TilingConfig,
)
from .. import ops
from ..ops import xla as ops_xla


TILED = "tiled"
LINEAR = "linear"


def _bilateral_impl(layout: str):
    if layout == TILED:
        return ops.bilateral
    if layout == LINEAR:
        return ops_xla.bilateral_xla
    raise ValueError(f"unknown layout {layout!r}")


@dataclasses.dataclass(frozen=True)
class BilateralDenoiser:
    """Plain bilateral filter (tiled or linear layout variant)."""

    params: BilateralParams = BilateralParams()
    layout: str = TILED
    tiling: Optional[TilingConfig] = None

    def __call__(self, img: jnp.ndarray) -> jnp.ndarray:
        if self.layout == TILED:
            return ops.bilateral(img, self.params, self.tiling)
        return ops_xla.bilateral_xla(img, self.params)


@dataclasses.dataclass(frozen=True)
class LayerGuidedDenoiser:
    """Cross-bilateral guided by G-buffer layers.

    One accumulation pass per layer into a shared (weightColor, normWeight)
    buffer, then a single normalize pass -- the reference's per-layer dispatch
    loop (src/main.cpp:1608-1624) expressed as a lax.scan over stacked layers.
    """

    params: LayersParams = LayersParams()
    norm_params: NormalizeParams = NormalizeParams()
    layout: str = TILED
    tiling: Optional[TilingConfig] = None

    @functools.partial(jax.jit, static_argnums=0)
    def __call__(self, target: jnp.ndarray, layers: jnp.ndarray) -> jnp.ndarray:
        """target: (H, W, 4); layers: (L, H, W, 4) stacked G-buffer layers."""
        accumulate = (
            ops.cross_bilateral_layers if self.layout == TILED
            else ops_xla.cross_bilateral_layers_xla
        )
        h, w, _ = target.shape

        def body(carry, layer):
            wc, nw = carry
            pwc, pnw = accumulate(target, layer, self.params, *(
                (self.tiling,) if self.layout == TILED else ()
            ))
            return (wc + pwc, nw + pnw), None

        init = (
            jnp.zeros((h, w, 4), jnp.float32),
            jnp.zeros((h, w), jnp.float32),
        )
        (wc, nw), _ = jax.lax.scan(body, init, layers)
        return ops.normalize(wc, nw, self.norm_params)


@dataclasses.dataclass(frozen=True)
class NlmDenoiser:
    """Single-frame non-local means: the target is matched against itself
    (the reference binds the target as both u_targetImage and u_neighbourImage,
    src/main.cpp:1521-1528 + loop over the single loaded frame)."""

    params: NlmParams = NlmParams()
    norm_params: NormalizeParams = NormalizeParams()
    layout: str = TILED
    tiling: Optional[TilingConfig] = None

    @functools.partial(jax.jit, static_argnums=0)
    def __call__(self, img: jnp.ndarray) -> jnp.ndarray:
        accumulate = (
            ops.nlm_accumulate if self.layout == TILED else ops_xla.nlm_xla
        )
        args = (self.tiling,) if self.layout == TILED else ()
        wc, nw = accumulate(img, img, self.params, *args)
        return ops.normalize(wc, nw, self.norm_params)


@dataclasses.dataclass(frozen=True)
class TemporalNlmDenoiser:
    """Multiframe temporal NLM: weight partials accumulate across neighbor
    frames (each frame contributes its norm seed, shaders/nonlocal.comp:32,
    61-62), one normalize at the end (src/main.cpp:1649-1652).

    The flagship model: each frame's partials come from the GPU NLM kernel.
    Frame streaming / double-buffered prefetch (the copy/compute overlap
    analog) is handled by runtime.prefetch when frames don't all fit on
    device.
    """

    params: NlmParams = NlmParams()
    norm_params: NormalizeParams = NormalizeParams()
    layout: str = TILED
    tiling: Optional[TilingConfig] = None

    @functools.partial(jax.jit, static_argnums=0)
    def __call__(self, target: jnp.ndarray, frames: jnp.ndarray) -> jnp.ndarray:
        """target: (H, W, 4); frames: (F, H, W, 4) neighbor frames (the target
        itself is frames[0] in the reference's loop, src/main.cpp:1574-1607)."""
        wc, nw = self.accumulate(target, frames)
        return ops.normalize(wc, nw, self.norm_params)

    @functools.partial(jax.jit, static_argnums=0)
    def accumulate(
        self, target: jnp.ndarray, frames: jnp.ndarray
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Accumulated (weightColor, normWeight) over all frames.

        Tiled layout: ONE frame-batched kernel launch whose programs loop over
        the frames, keeping the weight accumulators in registers across
        frames (the reference's persistent weights buffer,
        src/main.cpp:1430-1433). Linear layout: per-frame scan."""
        if self.layout == TILED:
            return ops.nlm_accumulate_frames(target, frames, self.params, self.tiling)
        h, w, _ = target.shape

        def body(carry, frame):
            wc, nw = carry
            pwc, pnw = ops_xla.nlm_xla(target, frame, self.params)
            return (wc + pwc, nw + pnw), None

        init = (
            jnp.zeros((h, w, 4), jnp.float32),
            jnp.zeros((h, w), jnp.float32),
        )
        (wc, nw), _ = jax.lax.scan(body, init, frames)
        return wc, nw

    def accumulate_one(
        self,
        target: jnp.ndarray,
        frame: jnp.ndarray,
        carry: tuple[jnp.ndarray, jnp.ndarray] | None,
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Streaming form: fold one frame into the carry (for the prefetch
        pipeline, where frames arrive one at a time)."""
        accumulate = (
            ops.nlm_accumulate if self.layout == TILED else ops_xla.nlm_xla
        )
        args = (self.tiling,) if self.layout == TILED else ()
        pwc, pnw = accumulate(target, frame, self.params, *args)
        if carry is None:
            return pwc, pnw
        return carry[0] + pwc, carry[1] + pnw

    def finalize(self, carry: tuple[jnp.ndarray, jnp.ndarray]) -> jnp.ndarray:
        return ops.normalize(carry[0], carry[1], self.norm_params)

"""Device mesh construction for multi-chip denoising.

The reference is strictly single-device (deviceId 0 hardcoded,
src/main.cpp:1321; one queue, vk_utils.cpp:260). Here parallelism is
first-class: a 2D mesh ('frame', 'y') carries frame-level data parallelism
(temporal NLM partials psum over 'frame') and spatial row-sharding (halo
exchange along 'y').
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

FRAME_AXIS = "frame"
SPATIAL_AXIS = "y"


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (FRAME_AXIS, SPATIAL_AXIS),
    devices=None,
) -> Mesh:
    """Build a mesh over the available devices.

    shape=None puts all devices on the spatial axis (shape (1, N)) -- the
    right default for single-image denoising, where spatial sharding is the
    only way to split one frame's work.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = (1, n)
    need = int(np.prod(shape))
    if need > n:
        raise ValueError(f"mesh shape {tuple(shape)} needs {need} devices, have {n}")
    arr = np.asarray(devices[:need]).reshape(shape)
    return Mesh(arr, tuple(axis_names))

from .mesh import FRAME_AXIS, SPATIAL_AXIS, make_mesh  # noqa: F401
from .spatial import (  # noqa: F401
    spatial_bilateral,
    spatial_cross_bilateral_layers,
    spatial_nlm_accumulate,
    temporal_nlm_sharded,
)

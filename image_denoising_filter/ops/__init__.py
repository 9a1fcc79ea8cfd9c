"""Device kernels: GPU stencil kernels (tiled layout), XLA variants (linear
layout), and NumPy oracles.

Three interchangeable implementations of each kernel:
  * `stencils.*` -- hand-tiled Pallas kernels (Triton route) that keep their
    accumulators in registers (the "tiled optimal texture" analog, the
    production path);
  * `xla.*` -- whole-image XLA versions (the "linear texel buffer" analog,
    the plain reference on the card and the differentiable path);
  * `reference.*` -- NumPy oracles (the test ground truth).
"""

from .fast import (  # noqa: F401
    bilateral_fast,
    cross_bilateral_layers_fast,
    normalize_layers_fast,
)
from .stencils import (  # noqa: F401
    bilateral,
    cross_bilateral_layers,
    nlm_accumulate,
    nlm_accumulate_frames,
)
from .xla import (  # noqa: F401
    bilateral_xla,
    cross_bilateral_layers_xla,
    nlm_xla,
    normalize,
)

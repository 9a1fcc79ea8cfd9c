"""image_denoising_filter: a JAX (XLA/Pallas) image-denoising
framework with the capabilities of the Vulkan-compute reference
Reefufui/image_denoising_filter.

Subpackages:
  ops      -- GPU stencil kernels, XLA variants + pure-NumPy oracles for the five device kernels
  models   -- denoiser pipelines (bilateral, layer-guided, NLM, temporal NLM)
  parallel -- device mesh, spatial sharding with halo exchange, frame DP
  runtime  -- session orchestration, frame prefetch, timing
  utils    -- PNG/EXR codecs, dataset discovery, progress, timing helpers
"""

__version__ = "0.1.0"

from . import config  # noqa: F401

"""Deprecated import path of `image_denoising_filter`.

Importing this package warns and registers every module of
`image_denoising_filter` under this name too, so old imports such as
`from <this package>.ops import stencils` get the very same module objects.
Import `image_denoising_filter` instead.
"""

import importlib
import pkgutil
import sys
import warnings

import image_denoising_filter as _pkg

warnings.warn(
    f"{__name__} is deprecated; import {_pkg.__name__} instead",
    DeprecationWarning,
    stacklevel=2,
)
for _mod in pkgutil.walk_packages(_pkg.__path__, _pkg.__name__ + "."):
    sys.modules[__name__ + _mod.name[len(_pkg.__name__):]] = importlib.import_module(_mod.name)
sys.modules[__name__] = _pkg

"""radler_tpu: a JAX radio-astronomical deconvolution framework.

A from-scratch JAX/XLA/Pallas rebuild with the capabilities of Radler (the
Radio Astronomical Deconvolution Library, reference at
``/root/reference``): Högbom/Clark CLEAN, multiscale CLEAN, IUWT
wavelet-sparsity deconvolution, ASP, joined-channel/polarization peak
finding, spectral fitting, auto-masking and faceted parallel deconvolution —
expressed as batched, jit-compiled matching-pursuit iterations over sharded
image cubes.

Public API mirrors the reference's Python bindings (``python/pyradler.cc``)::

    import radler_tpu as rd
    settings = rd.Settings()
    settings.algorithm_type = rd.AlgorithmType.GENERIC_CLEAN
    ...
    r = rd.Radler(settings, psf, residual, model, beam_size)
    another_needed = r.perform(0)
"""

import os as _os

# Where compiled programs are kept when JAX_COMPILATION_CACHE_DIR is not set:
# a fixed path in the checkout, so every process of this checkout finds the
# programs compiled before it (the path is part of JAX's cache key).
COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)


def _enable_persistent_compilation_cache() -> None:
    """Wire up JAX's persistent compilation cache at import time.

    The hot paths are single large jitted programs (the fused multiscale
    minor loop, the Högbom and Clark loops) whose cold compiles take
    seconds; caching them on disk spares every later process that cost
    (the reference has no equivalent problem: FFTW wisdom plays the same
    role for it, ``cpp/radler.cc:114-117``).  Where
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX uses that directory and no
    other is set here.
    """
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    if jax.config.jax_compilation_cache_dir is None:
        jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)


_enable_persistent_compilation_cache()

from .settings import (
    AlgorithmType,
    LocalRmsMethod,
    MultiscaleShape,
    OptimizationAlgorithm,
    Polarization,
    Settings,
    SpectralFittingMode,
)
from .work_table import (
    ImageAccessor,
    LoadAndStoreImageAccessor,
    LoadOnlyImageAccessor,
    PsfOffset,
    WorkTable,
    WorkTableEntry,
)
from .component_list import ComponentList
from .image_set import ImageSet
from .radler import Radler
from . import checkpoint

__version__ = "0.1.0"

__all__ = [
    "AlgorithmType",
    "ComponentList",
    "ImageAccessor",
    "ImageSet",
    "LoadAndStoreImageAccessor",
    "LoadOnlyImageAccessor",
    "LocalRmsMethod",
    "MultiscaleShape",
    "OptimizationAlgorithm",
    "Polarization",
    "PsfOffset",
    "Radler",
    "Settings",
    "SpectralFittingMode",
    "WorkTable",
    "WorkTableEntry",
]

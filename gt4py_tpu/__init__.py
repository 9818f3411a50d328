"""gt4py_tpu: a Cartesian stencil framework in JAX.

A brand-new framework with the capabilities of GT4Py (GridTools for Python):
a GTScript-style Python-embedded DSL for weather & climate stencils --
parallel I/J axes, sequential FORWARD/BACKWARD K loops, relative offsets,
intervals, horizontal regions, externals, data dimensions -- compiled through
a small validated stencil IR with extent/halo analysis into JAX/XLA programs
and Pallas column kernels (Triton route) for the GPU.

Layer map (a JAX redesign of the reference's architecture; see SURVEY.md):

    user API    gt4py_tpu.cartesian.gtscript  (@stencil, @function, Field, ...)
    frontend    Python AST -> StencilIR  (cartesian/frontend/)
    middle-end  validation + dtype inference + extent analysis (cartesian/analysis.py)
    executors   numpy oracle | jax (XLA) | pallas (Triton column kernels)
    runtime     StencilObject call machinery, storage allocators
    distributed parallel/ -- Mesh + shard_map halo exchange (net-new vs reference)
"""

__version__ = "0.1.0"
__version_info__ = (0, 1, 0)
__author__ = "gt4py_tpu contributors"
__license__ = "BSD-3-Clause"

from . import config  # noqa: F401
from . import storage  # noqa: F401  (reference: gt4py/__init__.py exports storage)

__all__ = [
    "__author__",
    "__license__",
    "__version__",
    "__version_info__",
    "config",
    "storage",
]

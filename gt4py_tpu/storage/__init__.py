"""Storage: field allocation with origins (halos) and backend-aware layout.

Reference API: src/gt4py/storage/cartesian/interface.py:40-264
(``empty/zeros/ones/full/from_array`` with ``backend`` and ``aligned_index``).

Redesign: instead of the reference's aligned-malloc + layout-map
machinery, allocation returns either a mutable numpy ``FieldStorage``
(cpu backends, in-place semantics) or a jax-array-backed ``FieldStorage``
(jax/pallas backends, functionally updated by the executor and rebound on
the holder).  The ``aligned_index`` is the default origin, i.e. the halo
offset of the compute-domain start inside the allocated buffer.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FieldStorage",
    "empty",
    "zeros",
    "ones",
    "full",
    "from_array",
]

_JAX_BACKENDS = ("jax", "pallas")


class FieldStorage:
    """A field buffer + origin + axis names.

    Behaves like an array (``__array__``, shape, dtype, indexing) while
    carrying GT4Py's ``__gt_origin__``/``__gt_dims__`` metadata.  For jax
    backends, ``data`` is a ``jax.Array`` that executors replace on write
    (functional update); for numpy backends it is mutated in place.
    """

    def __init__(self, data, origin: Tuple[int, ...], dims: Tuple[str, ...], backend: str):
        self.data = data
        self.origin = tuple(int(o) for o in origin)
        self.dims = tuple(dims)
        self.backend = backend

    # --- array protocol --- #

    def __array__(self, dtype=None):
        arr = np.asarray(self.data)
        return arr.astype(dtype) if dtype is not None else arr

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return np.dtype(self.data.dtype)

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def __gt_origin__(self):
        return self.origin

    @property
    def __gt_dims__(self):
        return self.dims

    def __getitem__(self, key):
        return self.data[key]

    def __setitem__(self, key, value):
        import numpy as _np

        if isinstance(self.data, _np.ndarray):
            self.data[key] = value
        else:  # jax array: functional update
            self.data = self.data.at[key].set(value)

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.data)

    def block_until_ready(self):
        if hasattr(self.data, "block_until_ready"):
            self.data.block_until_ready()
        return self

    def __repr__(self):
        return (
            f"FieldStorage(shape={self.shape}, dtype={self.dtype}, "
            f"origin={self.origin}, dims={self.dims}, backend={self.backend!r})"
        )


def _default_dims(ndim_spatial: int, data_ndim: int) -> Tuple[str, ...]:
    spatial = ("I", "J", "K")[:ndim_spatial]
    return spatial + tuple(str(i) for i in range(data_ndim))


def _normalize(shape, aligned_index, dimensions, data_dims=()):
    shape = tuple(int(s) for s in shape)
    ndata = len(tuple(data_dims))
    nspatial = len(shape) - ndata
    if dimensions is None:
        dims = _default_dims(nspatial, ndata)
    else:
        dims = tuple(str(d) for d in dimensions)
        if len(dims) < len(shape):
            dims = dims + tuple(str(i) for i in range(len(shape) - len(dims)))
    if aligned_index is None:
        aligned_index = (0,) * nspatial
    return shape, tuple(int(i) for i in aligned_index), dims


def _wrap(array, backend, origin, dims) -> FieldStorage:
    if backend in _JAX_BACKENDS:
        from gt4py_tpu import config

        config.ensure_jax_config()
        import jax.numpy as jnp

        array = jnp.asarray(array)
    return FieldStorage(array, origin, dims, backend)


def empty(
    shape: Sequence[int],
    dtype=np.float64,
    *,
    backend: str = "numpy",
    aligned_index: Optional[Sequence[int]] = None,
    dimensions: Optional[Sequence[str]] = None,
    data_dims: Sequence[int] = (),
) -> FieldStorage:
    shape, origin, dims = _normalize(shape, aligned_index, dimensions, data_dims)
    return _wrap(np.empty(shape, dtype=dtype), backend, origin, dims)


def zeros(shape, dtype=np.float64, *, backend="numpy", aligned_index=None,
          dimensions=None, data_dims=()) -> FieldStorage:
    shape, origin, dims = _normalize(shape, aligned_index, dimensions, data_dims)
    return _wrap(np.zeros(shape, dtype=dtype), backend, origin, dims)


def ones(shape, dtype=np.float64, *, backend="numpy", aligned_index=None,
         dimensions=None, data_dims=()) -> FieldStorage:
    shape, origin, dims = _normalize(shape, aligned_index, dimensions, data_dims)
    return _wrap(np.ones(shape, dtype=dtype), backend, origin, dims)


def full(shape, fill_value, dtype=np.float64, *, backend="numpy", aligned_index=None,
         dimensions=None, data_dims=()) -> FieldStorage:
    shape, origin, dims = _normalize(shape, aligned_index, dimensions, data_dims)
    return _wrap(np.full(shape, fill_value, dtype=dtype), backend, origin, dims)


def from_array(
    data,
    dtype=None,
    *,
    backend: str = "numpy",
    aligned_index: Optional[Sequence[int]] = None,
    dimensions: Optional[Sequence[str]] = None,
    data_dims: Sequence[int] = (),
) -> FieldStorage:
    arr = np.asarray(data)
    if dtype is not None:
        arr = arr.astype(dtype)
    else:
        arr = arr.copy()
    shape, origin, dims = _normalize(arr.shape, aligned_index, dimensions, data_dims)
    return _wrap(arr, backend, origin, dims)

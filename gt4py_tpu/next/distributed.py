"""Distributed execution for the field-view DSL (GSPMD path).

The reference is single-process (SURVEY.md §2.7: no distributed code
anywhere under src/); this layer is net-new, mirroring what
``gt4py_tpu.parallel`` provides for cartesian stencils.

Design: a ``next.Field``'s data is a jax array, so distribution
is *sharding*, not new execution machinery.  ``distribute`` places the
data with a ``NamedSharding`` mapping field dimensions onto device-mesh
axes; field operators staged under ``jax.jit`` (the ``jax_jit`` backend
or any jit-wrapped composition) then run SPMD — XLA partitions the
pointwise work and inserts halo collective-permutes over ICI for the
domain-shift offsets automatically.  The vertical (K) dimension stays
on-chip (scans need the full column; the reference never splits K
either — SURVEY.md §5 "long-context analog").

Usage::

    from gt4py_tpu.parallel import CartesianMesh
    from gt4py_tpu.next import distributed as nxd

    cmesh = CartesianMesh((2, 4))
    f = nxd.distribute(f, cmesh, {I: "x", J: "y"})
    out = jax.jit(lambda f: lap(f))(f)      # SPMD; halos via ppermute
    nxd.gather(out)                          # numpy-backed global Field

Sharded unstructured remaps (gathers through a Connectivity) are
all-to-all under GSPMD; keep connectivity tables replicated and shard
only the dense horizontal dimension.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .common import Dimension, DimensionKind, Field


def _jax_mesh(mesh):
    """Accept a parallel.CartesianMesh or a raw jax Mesh."""
    return getattr(mesh, "mesh", mesh)


def infer_dim_map(field: Field, mesh) -> Dict[Dimension, str]:
    """Default dimension→mesh-axis mapping: horizontal field dims are
    assigned to mesh axes in order; vertical/local dims stay on-chip."""
    jmesh = _jax_mesh(mesh)
    axes = list(jmesh.axis_names)
    out: Dict[Dimension, str] = {}
    for d in field.dims:
        if d.kind == DimensionKind.HORIZONTAL and axes:
            out[d] = axes.pop(0)
    return out


def field_sharding(field: Field, mesh, dim_map: Optional[Dict[Dimension, str]] = None):
    """NamedSharding for ``field`` with ``dim_map`` dims sharded."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    jmesh = _jax_mesh(mesh)
    if dim_map is None:
        dim_map = infer_dim_map(field, mesh)
    for d, ax in dim_map.items():
        if d not in field.dims:
            raise ValueError(f"dim_map names {d.value}, not a field dimension")
        if ax not in jmesh.axis_names:
            raise ValueError(f"dim_map maps {d.value} to unknown mesh axis {ax!r}")
        if d.kind == DimensionKind.VERTICAL:
            raise ValueError(
                f"refusing to shard vertical dimension {d.value}: serial-K "
                "scans need the full column on-chip (keep K local)"
            )
        n = jmesh.shape[ax]
        if len(field.domain[d]) % n:
            raise ValueError(
                f"dimension {d.value} (size {len(field.domain[d])}) does not "
                f"divide evenly over mesh axis {ax!r} ({n} devices)"
            )
    spec = P(*(dim_map.get(d) for d in field.dims))
    return NamedSharding(jmesh, spec)


def distribute(
    field: Field,
    mesh,
    dim_map: Optional[Dict[Dimension, str]] = None,
) -> Field:
    """Shard a field's data over the device mesh (global view: the domain
    is unchanged; only placement changes)."""
    import jax

    sharding = field_sharding(field, mesh, dim_map)
    return Field(field.domain, jax.device_put(field.data, sharding))


def replicate(value, mesh):
    """Place a Field (or a Connectivity's table) fully replicated on every
    device of the mesh — the right placement for neighbor tables and
    boundary masks."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .common import Connectivity

    sharding = NamedSharding(_jax_mesh(mesh), P())
    if isinstance(value, Connectivity):
        import jax.numpy as jnp

        return Connectivity(
            jax.device_put(jnp.asarray(value.table), sharding),
            source=value.source,
            codomain=value.codomain,
            local_dim=value.local_dim,
            skip_value=value.skip_value,
        )
    return Field(value.domain, jax.device_put(value.data, sharding))


def operator_halo(op, dims) -> Dict[Dimension, int]:
    """Halo width the operator needs per dimension, derived from the typed
    IR's extent analysis (extents.operator_extents): the widest read
    offset over all parameters.  Data-dependent reads (variable offsets,
    remaps) along a sharded dim are rejected."""
    from .extents import FULL, operator_extents

    ext = operator_extents(op)
    halos: Dict[Dimension, int] = {}
    for d in dims:
        h = 0
        for dmaps in ext.values():
            e = dmaps.get(d, (0, 0))
            if e is FULL:
                raise ValueError(
                    f"operator '{op.__name__}' reads {d.value} at "
                    "data-dependent offsets; cannot shard that dimension"
                )
            h = max(h, -e[0], e[1])
        halos[d] = h
    return halos


def shard_map_operator(
    op,
    mesh,
    dim_map: Optional[Dict[Dimension, str]] = None,
    *,
    periodic=True,
    boundary: str = "zero",
):
    """Explicit-halo-exchange execution of a field operator over the mesh
    (the shard_map counterpart of the GSPMD path; cartesian analog:
    parallel.shard_map_stencil).

    Halo widths come from the operator's own extent analysis — no manual
    bookkeeping.  Inside ``shard_map`` each local block is padded, the
    pad fills from mesh neighbors via ``lax.ppermute`` (rings when
    ``periodic``, else ``boundary`` = "zero"/"clamp" at the open edges),
    the operator runs eagerly on the halo-extended local Field, and the
    interior is returned re-assembled as a sharded global Field.

    All field arguments must share the same dims and domain; the operator
    must return field(s) over those dims (the stencil-on-mesh shape).
    Scalars pass through as keyword arguments.
    """
    import jax
    from jax.sharding import PartitionSpec as P

    from gt4py_tpu.parallel.halo import halo_exchange

    from .common import Domain, UnitRange

    jmesh = _jax_mesh(mesh)

    def step(*fields, **scalars):
        import jax.numpy as jnp

        f0 = fields[0]
        for f in fields[1:]:
            if f.dims != f0.dims or f.domain.ranges != f0.domain.ranges:
                raise ValueError(
                    "shard_map_operator requires all field arguments to "
                    "share dims and domain"
                )
        dmap = dim_map if dim_map is not None else infer_dim_map(f0, mesh)
        sdims = list(dmap)
        if not 1 <= len(sdims) <= 2:
            raise ValueError("shard one or two dimensions")
        halos = operator_halo(op, sdims)
        ax = {d: f0.dims.index(d) for d in sdims}
        per = (periodic, periodic) if isinstance(periodic, bool) else tuple(periodic)

        # halo_exchange works on two axes; a single sharded dim gets a
        # zero-width second axis (short-circuited inside)
        d0 = sdims[0]
        d1 = sdims[1] if len(sdims) > 1 else sdims[0]
        hpair = (halos[d0], halos[d1] if len(sdims) > 1 else 0)
        spatial = (ax[d0], ax[d1])
        mesh_axes = (dmap[d0], dmap[d1])

        def local_step(*arrs):
            padded = []
            for arr in arrs:
                pad_width = [(0, 0)] * arr.ndim
                for d in sdims:
                    pad_width[ax[d]] = (halos[d], halos[d])
                arr = jnp.pad(arr, pad_width)
                padded.append(
                    halo_exchange(
                        arr, hpair, axes=mesh_axes, spatial_axes=spatial,
                        periodic=per, boundary=boundary,
                    )
                )
            local_fields = []
            for arr in padded:
                ranges = tuple(
                    UnitRange(-halos[d], arr.shape[i] - halos[d])
                    if d in halos
                    else UnitRange(0, arr.shape[i])
                    for i, d in enumerate(f0.dims)
                )
                local_fields.append(Field(Domain(f0.dims, ranges), arr))
            out = op(*local_fields, **scalars)
            interior = Domain(
                tuple(sdims),
                tuple(
                    UnitRange(0, padded[0].shape[ax[d]] - 2 * halos[d])
                    for d in sdims
                ),
            )

            def crop(o):
                if o.dims != f0.dims:
                    raise ValueError(
                        "shard_map_operator expects the operator to return "
                        f"fields over {[d.value for d in f0.dims]}, got "
                        f"{[d.value for d in o.dims]}"
                    )
                return o.restrict(interior).data

            if isinstance(out, tuple):
                return tuple(crop(o) for o in out)
            return crop(out)

        spec = P(*(dmap.get(d) for d in f0.dims))
        n_out = len(op._decl_ret.types) if hasattr(op._decl_ret, "types") else 1
        mapped = jax.shard_map(
            local_step,
            mesh=jmesh,
            in_specs=(spec,) * len(fields),
            out_specs=(spec,) * n_out if n_out > 1 else spec,
            check_vma=False,
        )
        datas = mapped(*(f.data for f in fields))
        wrap = lambda data: Field(f0.domain, data)  # noqa: E731
        if isinstance(datas, tuple):
            return tuple(wrap(x) for x in datas)
        return wrap(datas)

    return step


def gather(field: Field) -> Field:
    """Fetch a (possibly sharded) field fully to host as a numpy-backed
    Field (oracle-compatible)."""
    return Field(field.domain, np.asarray(field.data))


def sharding_of(field: Field):
    """The jax sharding of the field's data (None for numpy-backed)."""
    return getattr(field.data, "sharding", None)

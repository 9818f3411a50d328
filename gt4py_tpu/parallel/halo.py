"""Explicit halo exchange with XLA collectives inside ``shard_map``.

Each shard holds a local block extended by halo rows/columns; neighbors
swap edge strips via ``lax.ppermute`` over the mesh axes.  Corners are
handled by exchanging I first (including the J-halo rows), then J -- the
standard two-phase scheme that makes corner values travel two hops.

Boundary semantics per axis (reference counterpart: the halo-exchange
layer the reference delegates to its distributed storage; here it is XLA
collectives over the ICI mesh):

- periodic: the mesh axis is a ring (``ppermute`` includes the wrap pair).
- non-periodic: edge shards get no remote data on their outer side;
  the physical-boundary halo is filled per ``boundary``:
  ``"zero"`` (ppermute's no-sender semantics) or ``"clamp"``
  (edge-replicate, i.e. zero-gradient outflow).

Communication/computation overlap (``overlapped_shard_map_stencil``):
the ppermutes are issued first, the interior sub-block (independent of
any halo) is computed from the un-exchanged data, and only the
halo-dependent boundary strips wait for the collectives -- XLA's
latency-hiding scheduler then runs the ppermutes concurrently with the
interior stencil work.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from gt4py_tpu import config


def _slice_axis(arr, axis, start, stop):
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(start, stop)
    return arr[tuple(idx)]


def _end_slice(arr, axis, h):
    size = arr.shape[axis]
    return slice(size - h, size)


def _set_axis(arr, axis, sl, value):
    idx = [slice(None)] * arr.ndim
    idx[axis] = sl
    return arr.at[tuple(idx)].set(value)


def _repeat_edge(arr, axis, h):
    """h copies of the single plane ``arr`` along ``axis`` (clamp fill)."""
    import jax.numpy as jnp

    return jnp.concatenate([arr] * h, axis=axis)


def halo_exchange(
    local,
    halo: Tuple[int, int],
    axes=("x", "y"),
    spatial_axes=(0, 1),
    periodic: Tuple[bool, bool] = (True, True),
    boundary: str = "zero",
    wire_dtype=None,
):
    """Swap halos of a local block with mesh neighbors.

    ``spatial_axes`` selects the (I, J) array axes -- (0, 1) for logical
    (I, J, K) blocks, (1, 2) for the executor's physical K-leading layout.
    The I/J extents include the halo (ni + 2*hi etc.).  ``periodic`` picks
    ring vs open topology per mesh axis; open edges fill their outer halo
    per ``boundary`` ("zero" | "clamp").  Must run inside ``shard_map``
    over a mesh with the given axes.

    ``wire_dtype`` (e.g. ``jnp.bfloat16``) casts the exchanged edge
    strips to a narrower WIRE format before the ppermute and back to the
    block dtype on arrival: the interior compute stays full precision,
    only the halo values round once -- halving (f32) or quartering (f64)
    the interconnect bytes per exchange.  Single-shard
    wrap/boundary fills apply the same rounding so an N=1 mesh axis is
    bit-identical to an N>1 one.
    """
    import jax
    from jax import lax
    import jax.numpy as jnp

    if boundary not in ("zero", "clamp"):
        raise ValueError(f"boundary must be 'zero' or 'clamp', got {boundary!r}")

    hi, hj = halo

    def _wire(strip):
        if wire_dtype is None or strip.dtype == jnp.dtype(wire_dtype):
            return strip
        return strip.astype(wire_dtype)

    def _unwire(strip):
        return strip if wire_dtype is None else strip.astype(local.dtype)

    def _exchange_axis(block, h, mesh_axis, array_axis, wrap):
        if h == 0:
            return block
        n = lax.axis_size(mesh_axis)
        size = block.shape[array_axis]
        if n == 1:
            if wrap:
                interior = _slice_axis(block, array_axis, h, -h)
                lo_strip = _unwire(_wire(_slice_axis(interior, array_axis, 0, h)))
                hi_strip = _unwire(_wire(_slice_axis(interior, array_axis, -h, None)))
                block = _set_axis(block, array_axis, slice(0, h), hi_strip)
                block = _set_axis(
                    block, array_axis, _end_slice(block, array_axis, h), lo_strip
                )
                return block
            if boundary == "zero":
                zeros = jnp.zeros_like(_slice_axis(block, array_axis, 0, h))
                block = _set_axis(block, array_axis, slice(0, h), zeros)
                block = _set_axis(
                    block, array_axis, _end_slice(block, array_axis, h), zeros
                )
            else:  # clamp
                lo_plane = _slice_axis(block, array_axis, h, h + 1)
                hi_plane = _slice_axis(block, array_axis, size - h - 1, size - h)
                block = _set_axis(
                    block, array_axis, slice(0, h), _repeat_edge(lo_plane, array_axis, h)
                )
                block = _set_axis(
                    block,
                    array_axis,
                    _end_slice(block, array_axis, h),
                    _repeat_edge(hi_plane, array_axis, h),
                )
            return block
        fwd = [(i, (i + 1) % n) for i in range(n if wrap else n - 1)]
        bwd = [(i, (i - 1) % n) for i in range(n) if wrap or i > 0]
        # my interior high edge -> right neighbor's low halo
        hi_edge = _wire(_slice_axis(block, array_axis, -2 * h, -h))
        lo_halo = _unwire(lax.ppermute(hi_edge, mesh_axis, fwd))
        # my interior low edge -> left neighbor's high halo
        lo_edge = _wire(_slice_axis(block, array_axis, h, 2 * h))
        hi_halo = _unwire(lax.ppermute(lo_edge, mesh_axis, bwd))
        if not wrap and boundary == "clamp":
            # edge shards received zeros (ppermute no-sender); replace with
            # their own edge plane (zero-gradient)
            pos = lax.axis_index(mesh_axis)
            lo_plane = _slice_axis(block, array_axis, h, h + 1)
            hi_plane = _slice_axis(block, array_axis, size - h - 1, size - h)
            lo_halo = jnp.where(
                pos == 0, _repeat_edge(lo_plane, array_axis, h), lo_halo
            )
            hi_halo = jnp.where(
                pos == n - 1, _repeat_edge(hi_plane, array_axis, h), hi_halo
            )
        block = _set_axis(block, array_axis, slice(0, h), lo_halo)
        block = _set_axis(block, array_axis, _end_slice(block, array_axis, h), hi_halo)
        return block

    local = _exchange_axis(local, hi, axes[0], spatial_axes[0], periodic[0])
    local = _exchange_axis(local, hj, axes[1], spatial_axes[1], periodic[1])
    return local


def _field_spec(spatial_axes):
    from jax.sharding import PartitionSpec as P

    ax_i, ax_j = spatial_axes
    spec_entries = [None] * (max(spatial_axes) + 1)
    spec_entries[ax_i] = "x"
    spec_entries[ax_j] = "y"
    return P(*spec_entries)


def shard_map_stencil(
    stencil_fn: Callable[..., Dict],
    cmesh,
    halo: Tuple[int, int],
    *,
    field_names,
    scalar_names=(),
    spatial_axes=(0, 1),
    periodic: Tuple[bool, bool] = (True, True),
    boundary: str = "zero",
    extended_state: bool = False,
    halo_wire_dtype=None,
):
    """Wrap a local stencil function into a sharded step.

    ``extended_state=False`` (default): field arguments are plain *global*
    (NI, NJ, ...) arrays sharded with ``P("x", "y")``.  Inside
    ``shard_map`` each local block is padded by the halo, the pad is
    filled from the neighbors via ``ppermute``, ``stencil_fn(
    **halo_extended_locals, **scalars) -> dict(updated)`` runs (blocks of
    shape (ni + 2*hi, nj + 2*hj, ...), origin (hi, hj, 0), domain
    (ni, nj, K)), and the interiors of the updated fields are returned
    re-assembled as sharded globals.

    ``extended_state=True``: fields are kept in the *halo-extended* local
    layout between steps (global shape px*(ni+2*hi) x py*(nj+2*hj)),
    removing the per-step pad/crop copies entirely; use ``to_extended`` /
    ``from_extended`` to convert at the boundaries of the time loop.
    """
    import jax

    field_names = tuple(field_names)
    scalar_names = tuple(scalar_names)
    hi, hj = halo
    ax_i, ax_j = spatial_axes

    def local_step(*args):
        import jax.numpy as jnp

        fields = dict(zip(field_names, args[: len(field_names)]))
        scalars = dict(zip(scalar_names, args[len(field_names):]))
        padded = {}
        for name, arr in fields.items():
            if not extended_state:
                pad_width = [(0, 0)] * arr.ndim
                pad_width[ax_i] = (hi, hi)
                pad_width[ax_j] = (hj, hj)
                arr = jnp.pad(arr, pad_width)
            padded[name] = halo_exchange(
                arr, halo, spatial_axes=spatial_axes,
                periodic=periodic, boundary=boundary,
                wire_dtype=halo_wire_dtype,
            )
        out = stencil_fn(**padded, **scalars)
        merged = dict(padded)
        merged.update(out)
        result = []
        for n in field_names:
            b = merged[n]
            if extended_state:
                result.append(b)
                continue
            idx = [slice(None)] * b.ndim
            idx[ax_i] = slice(hi, b.shape[ax_i] - hi)
            idx[ax_j] = slice(hj, b.shape[ax_j] - hj)
            result.append(b[tuple(idx)])
        return tuple(result)

    field_spec = _field_spec(spatial_axes)
    from jax.sharding import PartitionSpec as P

    in_specs = tuple([field_spec] * len(field_names) + [P()] * len(scalar_names))
    out_specs = tuple([field_spec] * len(field_names))

    mapped = jax.shard_map(
        local_step,
        mesh=cmesh.mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )

    def step(**kwargs):
        args = [kwargs[n] for n in field_names] + [kwargs[n] for n in scalar_names]
        result = mapped(*args)
        return dict(zip(field_names, result))

    return step


def overlapped_shard_map_stencil(
    make_region_step,
    cmesh,
    halo: Tuple[int, int],
    *,
    field_names,
    scalar_names=(),
    spatial_axes=(0, 1),
    periodic: Tuple[bool, bool] = (True, True),
    boundary: str = "zero",
    extended_state: bool = False,
    local_shape: Tuple[int, int],
    halo_wire_dtype=None,
):
    """Sharded step with communication/computation overlap.

    ``make_region_step((oi, oj), (di, dj)) -> fn(**fields) -> dict`` is a
    factory returning a step that computes the given region (origins in
    *halo-extended* local coordinates) and returns updated full blocks.
    The wrapper issues the halo ppermutes, computes the interior region
    (which reads no halo) from the pre-exchange data, computes the four
    boundary strips from the exchanged data, and stitches the results --
    the collectives are data-independent of the interior compute, so
    XLA's latency-hiding scheduler overlaps them.

    ``local_shape`` is the per-shard interior (ni, nj); both must exceed
    2*halo so a halo-independent interior exists.
    """
    import jax

    field_names = tuple(field_names)
    scalar_names = tuple(scalar_names)
    hi, hj = halo
    ax_i, ax_j = spatial_axes
    ni, nj = local_shape
    if ni <= 2 * hi or nj <= 2 * hj:
        raise ValueError(
            f"overlap needs local interior > 2*halo per axis, got {local_shape} vs {halo}"
        )

    # regions in halo-extended local coordinates (origin includes the halo)
    interior = ((2 * hi, 2 * hj), (ni - 2 * hi, nj - 2 * hj))
    strips = [
        ((hi, hj), (hi, nj)),                      # top rows (full width)
        ((ni, hj), (hi, nj)),                      # bottom rows
        ((2 * hi, hj), (ni - 2 * hi, hj)),         # left cols (minus corners)
        ((2 * hi, nj), (ni - 2 * hi, hj)),         # right cols
    ]
    interior_fn = make_region_step(*interior)
    strip_fns = [make_region_step(o, d) for (o, d) in strips]

    def _region_slice(b, origin, domain):
        idx = [slice(None)] * b.ndim
        idx[ax_i] = slice(origin[0], origin[0] + domain[0])
        idx[ax_j] = slice(origin[1], origin[1] + domain[1])
        return tuple(idx)

    def local_step(*args):
        import jax.numpy as jnp

        fields = dict(zip(field_names, args[: len(field_names)]))
        scalars = dict(zip(scalar_names, args[len(field_names):]))
        stale = {}
        for name, arr in fields.items():
            if not extended_state:
                pad_width = [(0, 0)] * arr.ndim
                pad_width[ax_i] = (hi, hi)
                pad_width[ax_j] = (hj, hj)
                arr = jnp.pad(arr, pad_width)
            stale[name] = arr
        exchanged = {
            name: halo_exchange(
                arr, halo, spatial_axes=spatial_axes,
                periodic=periodic, boundary=boundary,
                wire_dtype=halo_wire_dtype,
            )
            for name, arr in stale.items()
        }
        # interior: depends only on pre-exchange data -> overlaps the
        # ppermutes above in the XLA schedule
        out = dict(exchanged)
        out.update(interior_fn(**stale, **scalars))
        for (origin, domain), fn in zip(strips, strip_fns):
            strip_out = fn(**exchanged, **scalars)
            for name, b in strip_out.items():
                idx = _region_slice(b, origin, domain)
                out[name] = out[name].at[idx].set(b[idx])
        result = []
        for n in field_names:
            b = out[n]
            if extended_state:
                result.append(b)
                continue
            idx = [slice(None)] * b.ndim
            idx[ax_i] = slice(hi, b.shape[ax_i] - hi)
            idx[ax_j] = slice(hj, b.shape[ax_j] - hj)
            result.append(b[tuple(idx)])
        return tuple(result)

    field_spec = _field_spec(spatial_axes)
    from jax.sharding import PartitionSpec as P

    in_specs = tuple([field_spec] * len(field_names) + [P()] * len(scalar_names))
    out_specs = tuple([field_spec] * len(field_names))

    mapped = jax.shard_map(
        local_step,
        mesh=cmesh.mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )

    def step(**kwargs):
        args = [kwargs[n] for n in field_names] + [kwargs[n] for n in scalar_names]
        result = mapped(*args)
        return dict(zip(field_names, result))

    return step


def to_extended(cmesh, array, halo: Tuple[int, int], spatial_axes=(0, 1)):
    """Convert a sharded global (interior-only) array to the persistent
    halo-extended per-shard layout (halos zero until the first exchange)."""
    import jax

    hi, hj = halo
    ax_i, ax_j = spatial_axes
    spec = _field_spec(spatial_axes)

    def pad(local):
        import jax.numpy as jnp

        pad_width = [(0, 0)] * local.ndim
        pad_width[ax_i] = (hi, hi)
        pad_width[ax_j] = (hj, hj)
        return jnp.pad(local, pad_width)

    return jax.shard_map(
        pad, mesh=cmesh.mesh, in_specs=(spec,), out_specs=spec, check_vma=False
    )(array)


def from_extended(cmesh, array, halo: Tuple[int, int], spatial_axes=(0, 1)):
    """Crop the persistent halo-extended layout back to a sharded global."""
    import jax

    hi, hj = halo
    ax_i, ax_j = spatial_axes
    spec = _field_spec(spatial_axes)

    def crop(local):
        idx = [slice(None)] * local.ndim
        idx[ax_i] = slice(hi, local.shape[ax_i] - hi)
        idx[ax_j] = slice(hj, local.shape[ax_j] - hj)
        return local[tuple(idx)]

    return jax.shard_map(
        crop, mesh=cmesh.mesh, in_specs=(spec,), out_specs=spec, check_vma=False
    )(array)


def halo_comm_bytes(
    local_shape, halo: Tuple[int, int], dtype, spatial_axes=(0, 1),
    wire_dtype=None, n_fields: int = 1,
) -> int:
    """ICI/DCN bytes ONE halo_exchange moves per device per step: two
    directions per mesh axis, strips of the halo width times the other
    dimensions, at the WIRE dtype.  The accounting behind the bf16-wire
    claim (docs/performance.md): f32 payloads halve on the wire."""
    import numpy as np

    item = np.dtype(wire_dtype if wire_dtype is not None else dtype).itemsize
    hi, hj = halo
    other = 1
    for ax, n in enumerate(local_shape):
        if ax not in spatial_axes:
            other *= n
    ni, nj = local_shape[spatial_axes[0]], local_shape[spatial_axes[1]]
    per_field = 2 * (hi * nj + hj * ni) * other * item
    return per_field * n_fields

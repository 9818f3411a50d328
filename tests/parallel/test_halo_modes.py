"""Non-periodic boundaries, comm/compute overlap, persistent-halo state.

Reference counterpart: none (the reference is single-process; SURVEY.md
§2.7 names the distribution layer as net-new).  Equivalences checked:

- halo_exchange non-periodic modes vs a numpy reconstruction;
- overlapped_shard_map_stencil (interior/boundary split) is bitwise
  equal to the plain shard_map_stencil step;
- extended_state (persistent halos, no per-step pad/crop) round-trips.
"""

import numpy as np
import pytest

from gt4py_tpu.models.dycore import MiniDycore
from gt4py_tpu.parallel import (
    CartesianMesh,
    from_extended,
    gather,
    overlapped_shard_map_stencil,
    shard_map_stencil,
    to_extended,
)


def _mesh_2x4():
    return CartesianMesh((2, 4))


def _exchange_global(cmesh, arr, h, periodic, boundary):
    """Run halo_exchange over extended per-shard blocks; return the
    extended global for inspection."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gt4py_tpu.parallel import halo_exchange

    ext = to_extended(cmesh, arr, (h, h))

    def ex(b):
        return halo_exchange(b, (h, h), periodic=periodic, boundary=boundary)

    spec = P("x", "y")
    out = jax.shard_map(
        ex, mesh=cmesh.mesh, in_specs=(spec,), out_specs=spec, check_vma=False
    )(ext)
    return np.asarray(out)


def _blocks(ext_global, px, py, ni_e, nj_e):
    return {
        (i, j): ext_global[i * ni_e : (i + 1) * ni_e, j * nj_e : (j + 1) * nj_e]
        for i in range(px)
        for j in range(py)
    }


@pytest.mark.parametrize("boundary", ["zero", "clamp"])
def test_nonperiodic_halo_exchange(boundary):
    cmesh = _mesh_2x4()
    px, py = cmesh.shape
    h = 2
    ni_l, nj_l = 6, 6
    NI, NJ = px * ni_l, py * nj_l
    rng = np.random.default_rng(3)
    arr = rng.random((NI, NJ))

    ext = _exchange_global(cmesh, arr, h, (False, False), boundary)
    blocks = _blocks(ext, px, py, ni_l + 2 * h, nj_l + 2 * h)

    for (bi, bj), blk in blocks.items():
        interior = arr[bi * ni_l : (bi + 1) * ni_l, bj * nj_l : (bj + 1) * nj_l]
        np.testing.assert_array_equal(blk[h : h + ni_l, h : h + nj_l], interior)
        # interior-neighbor halos carry remote data
        if bi > 0:
            want = arr[bi * ni_l - h : bi * ni_l, bj * nj_l : (bj + 1) * nj_l]
            np.testing.assert_array_equal(blk[0:h, h : h + nj_l], want)
        else:
            # physical edge: boundary fill
            if boundary == "zero":
                np.testing.assert_array_equal(blk[0:h, h : h + nj_l], 0.0)
            else:
                want = np.repeat(interior[0:1, :], h, axis=0)
                np.testing.assert_array_equal(blk[0:h, h : h + nj_l], want)
        if bj == py - 1:
            if boundary == "zero":
                np.testing.assert_array_equal(blk[h : h + ni_l, h + nj_l :], 0.0)
            else:
                want = np.repeat(interior[:, -1:], h, axis=1)
                np.testing.assert_array_equal(blk[h : h + ni_l, h + nj_l :], want)


def test_periodic_halo_exchange_matches_roll():
    cmesh = _mesh_2x4()
    px, py = cmesh.shape
    h = 1
    ni_l, nj_l = 4, 4
    NI, NJ = px * ni_l, py * nj_l
    rng = np.random.default_rng(4)
    arr = rng.random((NI, NJ))

    ext = _exchange_global(cmesh, arr, h, (True, True), "zero")
    blocks = _blocks(ext, px, py, ni_l + 2 * h, nj_l + 2 * h)
    for (bi, bj), blk in blocks.items():
        # compare against a periodic gather of the global array
        gi = np.arange(bi * ni_l - h, (bi + 1) * ni_l + h) % NI
        gj = np.arange(bj * nj_l - h, (bj + 1) * nj_l + h) % NJ
        np.testing.assert_array_equal(blk, arr[np.ix_(gi, gj)])


@pytest.mark.parametrize(
    "periodic,boundary",
    [((True, True), "zero"), ((False, False), "clamp")],
)
def test_overlapped_step_matches_plain(periodic, boundary):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    NI, NJ, NK = 32, 64, 5
    cmesh = _mesh_2x4()
    px, py = cmesh.shape
    ni_l, nj_l = NI // px, NJ // py
    h = MiniDycore.HALO

    rng = np.random.default_rng(0)
    fields = {
        "u": rng.random((NK, NI, NJ)),
        "coeff": 0.025 * rng.random((NK, NI, NJ)),
        "wcon": 0.2 * rng.random((NK, NI, NJ)),
        "utens": 0.01 * rng.random((NK, NI, NJ)),
        "utens_stage": rng.random((NK, NI, NJ)),
    }
    field_names = tuple(fields)

    local = MiniDycore(ni_l, nj_l, NK, dtype=np.float64, backend="jax")
    local_step = local.step_fn(fill_halos=False)

    def local_fields_step(**kw):
        return local_step(dict(kw))

    plain = shard_map_stencil(
        local_fields_step,
        cmesh,
        (h, h),
        field_names=field_names,
        spatial_axes=(1, 2),
        periodic=periodic,
        boundary=boundary,
    )

    make = local.region_step_factory()

    def make_region(origin_ij, domain_ij):
        region = make(origin_ij, domain_ij)

        def fn(**kw):
            return region(**kw)

        return fn

    overlapped = overlapped_shard_map_stencil(
        make_region,
        cmesh,
        (h, h),
        field_names=field_names,
        spatial_axes=(1, 2),
        periodic=periodic,
        boundary=boundary,
        local_shape=(ni_l, nj_l),
    )

    sharding = NamedSharding(cmesh.mesh, P(None, "x", "y"))
    gstate = {k: jax.device_put(jnp.asarray(v), sharding) for k, v in fields.items()}
    out_plain = jax.jit(lambda **kw: plain(**kw))(**gstate)
    out_over = jax.jit(lambda **kw: overlapped(**kw))(**gstate)
    for name in ("u", "utens_stage"):
        a, b = gather(out_plain[name]), gather(out_over[name])
        np.testing.assert_array_equal(a, b)


def test_extended_state_round_trip_and_step():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    NI, NJ, NK = 16, 32, 4
    cmesh = _mesh_2x4()
    px, py = cmesh.shape
    ni_l, nj_l = NI // px, NJ // py
    h = MiniDycore.HALO

    rng = np.random.default_rng(1)
    fields = {
        "u": rng.random((NK, NI, NJ)),
        "coeff": 0.025 * rng.random((NK, NI, NJ)),
        "wcon": 0.2 * rng.random((NK, NI, NJ)),
        "utens": 0.01 * rng.random((NK, NI, NJ)),
        "utens_stage": rng.random((NK, NI, NJ)),
    }
    field_names = tuple(fields)

    local = MiniDycore(ni_l, nj_l, NK, dtype=np.float64, backend="jax")
    local_step = local.step_fn(fill_halos=False)

    def local_fields_step(**kw):
        return local_step(dict(kw))

    kw = dict(field_names=field_names, spatial_axes=(1, 2))
    plain = shard_map_stencil(local_fields_step, cmesh, (h, h), **kw)
    extended = shard_map_stencil(
        local_fields_step, cmesh, (h, h), extended_state=True, **kw
    )

    sharding = NamedSharding(cmesh.mesh, P(None, "x", "y"))
    gstate = {k: jax.device_put(jnp.asarray(v), sharding) for k, v in fields.items()}

    # round trip
    ext_u = to_extended(cmesh, gstate["u"], (h, h), spatial_axes=(1, 2))
    back = from_extended(cmesh, ext_u, (h, h), spatial_axes=(1, 2))
    np.testing.assert_array_equal(gather(back), fields["u"])

    # two steps in the persistent-extended layout == two plain steps
    est = {
        k: to_extended(cmesh, v, (h, h), spatial_axes=(1, 2))
        for k, v in gstate.items()
    }
    pst = dict(gstate)
    for _ in range(2):
        est = jax.jit(lambda **kw2: extended(**kw2))(**est)
        pst = jax.jit(lambda **kw2: plain(**kw2))(**pst)
    for name in ("u", "utens_stage"):
        got = gather(
            from_extended(cmesh, est[name], (h, h), spatial_axes=(1, 2))
        )
        np.testing.assert_array_equal(got, gather(pst[name]))

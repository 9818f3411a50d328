"""Distributed FV advection == single-device periodic FV advection.

The same fused Lin-Rood step runs (a) single-device with periodic
boundaries as a stencil execution option and (b) sharded over the
8-device virtual mesh with ppermute halo exchange; interiors must agree
bitwise (f64: identical per-point operation order)."""

import numpy as np

from gt4py_tpu.models.fv_advection import FvAdvection
from gt4py_tpu.parallel import CartesianMesh, gather, shard_map_stencil


def test_distributed_fv_matches_single_device():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    NI, NJ, NK = 16, 32, 4
    cmesh = CartesianMesh((2, 4))
    px, py = cmesh.shape
    ni_l, nj_l = NI // px, NJ // py
    h = FvAdvection.HALO

    rng = np.random.default_rng(7)
    q = rng.random((NK, NI, NJ))
    cx = 0.4 * (rng.random((NK, NI, NJ)) - 0.5)
    cy = 0.4 * (rng.random((NK, NI, NJ)) - 0.5)

    # single device, periodic product path
    single = FvAdvection(NI, NJ, NK, dtype=np.float64, backend="jax")
    shape = single.field_shape()

    def embed(a):
        buf = np.zeros(shape)
        buf[:, h : h + NI, h : h + NJ] = a
        return jnp.asarray(buf)

    step1 = single.step_fn()
    out1 = jax.jit(step1)(embed(q), embed(cx), embed(cy))
    q_single = np.asarray(out1)[:, h : h + NI, h : h + NJ]

    # sharded: ppermute halo exchange + non-periodic fused local step
    local = FvAdvection(ni_l, nj_l, NK, dtype=np.float64, backend="jax")
    lstep = local.local_step_fn()

    def local_fields_step(**kw):
        return {"q": lstep(kw["q"], kw["cx"], kw["cy"])}

    step_sh = shard_map_stencil(
        local_fields_step,
        cmesh,
        (h, h),
        field_names=("q", "cx", "cy"),
        spatial_axes=(1, 2),
    )
    sharding = NamedSharding(cmesh.mesh, P(None, "x", "y"))
    g = {
        name: jax.device_put(jnp.asarray(a), sharding)
        for name, a in [("q", q), ("cx", cx), ("cy", cy)]
    }
    out_sh = jax.jit(lambda **kw: step_sh(**kw))(**g)
    q_sharded = gather(out_sh["q"])

    np.testing.assert_array_equal(q_sharded, q_single)

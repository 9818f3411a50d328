"""Distributed shallow water == single-device periodic shallow water.

The C-grid forward-backward SWE step runs (a) single-device with
periodic boundaries as a stencil execution option and (b) sharded over
the 8-device virtual mesh with ppermute halo exchange; interiors must
agree bitwise (f64: identical per-point operation order).
"""

import numpy as np

from gt4py_tpu.models.shallow_water import ShallowWater
from gt4py_tpu.parallel import CartesianMesh, gather, shard_map_stencil


def test_distributed_shallow_water_matches_single_device():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    NI, NJ, NK = 16, 32, 3
    cmesh = CartesianMesh((2, 4))
    px, py = cmesh.shape
    ni_l, nj_l = NI // px, NJ // py
    h = ShallowWater.HALO

    single = ShallowWater(NI, NJ, NK, dtype=np.float64, backend="jax")
    st = single.init_state(seed=5)
    step1 = jax.jit(single.step_fn())
    outs1 = step1(*(jnp.asarray(st[k]) for k in ("h", "u", "v")))
    interior1 = [np.asarray(o)[:, h : h + NI, h : h + NJ] for o in outs1]

    local = ShallowWater(ni_l, nj_l, NK, dtype=np.float64, backend="jax")
    lstep = local.local_step_fn()

    def local_fields_step(**kw):
        hn, un, vn = lstep(kw["h"], kw["u"], kw["v"])
        return {"h": hn, "u": un, "v": vn}

    step_sh = shard_map_stencil(
        local_fields_step,
        cmesh,
        (h, h),
        field_names=("h", "u", "v"),
        spatial_axes=(1, 2),
    )
    sharding = NamedSharding(cmesh.mesh, P(None, "x", "y"))
    g = {
        name: jax.device_put(
            jnp.asarray(st[name][:, h : h + NI, h : h + NJ]), sharding
        )
        for name in ("h", "u", "v")
    }
    out_sh = jax.jit(lambda **kw: step_sh(**kw))(**g)
    for name, ref in zip(("h", "u", "v"), interior1):
        np.testing.assert_array_equal(gather(out_sh[name]), ref)

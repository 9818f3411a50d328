"""Distributed mini-dycore: one timestep sharded over a device mesh.

On a machine with one chip this runs on a virtual 8-device CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python examples/distributed_dycore.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )

import numpy as np


def main():
    import jax

    # honor a CPU request before the first backend use
    if "cpu" in os.environ.get("JAX_PLATFORMS", ""):
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gt4py_tpu.models import MiniDycore
    from gt4py_tpu.parallel import CartesianMesh, gather, shard_map_stencil

    cmesh = CartesianMesh()
    px, py = cmesh.shape
    print(f"mesh: {px} x {py} over {cmesh.size} devices")

    NI, NJ, NK = 32 * px, 32 * py, 16
    model = MiniDycore(32, 32, NK, dtype=np.float32, backend="jax")
    h = model.HALO

    step = shard_map_stencil(
        lambda **kw: model.step_fn(fill_halos=False)(dict(kw)),
        cmesh,
        (h, h),
        field_names=("u", "coeff", "wcon", "utens", "utens_stage"),
        spatial_axes=(1, 2),
    )

    sharding = NamedSharding(cmesh.mesh, P(None, "x", "y"))
    rng = np.random.default_rng(0)
    state = {
        name: jax.device_put(rng.random((NK, NI, NJ)).astype(np.float32) * s, sharding)
        for name, s in [("u", 1.0), ("coeff", 0.025), ("wcon", 0.2),
                        ("utens", 0.01), ("utens_stage", 1.0)]
    }

    run = jax.jit(lambda **kw: step(**kw))
    for i in range(5):
        state = run(**state)
    u = gather(state["u"])
    print(f"5 steps done; global u: shape={u.shape}, mean={u.mean():.4f}, "
          f"finite={np.isfinite(u).all()}")


if __name__ == "__main__":
    main()

"""Distributed field-view DSL: shard a next Field over a device mesh and
run jit-staged operators SPMD (GSPMD inserts the halo collectives).

Run on any machine -- uses 8 virtual CPU devices when no multi-chip
hardware is present:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/distributed_next.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )

import jax

# default to the virtual CPU mesh; set GT4PY_TPU_EXAMPLE_PLATFORM=gpu to
# run on the cards
if os.environ.get("GT4PY_TPU_EXAMPLE_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np

import gt4py_tpu.next as gtx
from gt4py_tpu.next import Dims, Field
from gt4py_tpu.next import distributed as nxd
from gt4py_tpu.parallel import CartesianMesh

I = gtx.Dimension("I")
J = gtx.Dimension("J")
K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)
Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
Joff = gtx.FieldOffset("Joff", source=J, target=(J,))


@gtx.field_operator
def laplacian(
    f: Field[Dims[I, J, K], gtx.float32]
) -> Field[Dims[I, J, K], gtx.float32]:
    return f(Ioff[1]) + f(Ioff[-1]) + f(Joff[1]) + f(Joff[-1]) - 4.0 * f


@gtx.scan_operator(axis=K, forward=True, init=np.float32(0.0))
def column_integral(carry: gtx.float32, x: gtx.float32) -> gtx.float32:
    return carry + x


def main() -> None:
    cmesh = CartesianMesh()  # most-square factorization of all devices
    px, py = cmesh.shape
    print(f"mesh: {px}x{py} over {cmesh.size} devices")

    ni, nj, nk = 16 * px, 16 * py, 8
    rng = np.random.default_rng(0)
    f = gtx.as_field((I, J, K), rng.random((ni, nj, nk)).astype(np.float32))

    # shard: I over mesh-axis x, J over y; K stays on-chip (scans need
    # the whole column)
    fd = nxd.distribute(f, cmesh, {I: "x", J: "y"})
    print("input sharding:", nxd.sharding_of(fd))

    # one fused SPMD program: laplacian (halo collective-permutes) into
    # a serial-K column scan over the sharded columns
    step = jax.jit(lambda g: column_integral(laplacian(g)).data)
    out = step(fd)
    print("output shape:", out.shape, "sharded:", not out.sharding.is_fully_replicated)

    # verify against the numpy-backed oracle on the gathered data
    ref = np.cumsum(
        laplacian(gtx.as_field((I, J, K), f.asnumpy(), allocator="numpy")).asnumpy(),
        axis=2,
        dtype=np.float32,
    )
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-6, atol=2e-6)
    print("matches the numpy oracle — OK")


if __name__ == "__main__":
    main()

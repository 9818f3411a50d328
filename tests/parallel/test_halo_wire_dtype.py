"""bf16 WIRE format for halo exchange (VERDICT r4 #6).

bf16's value here is memory capacity and DISTRIBUTED HALO BYTES.
This file substantiates the second: ``wire_dtype=bfloat16`` casts
only the exchanged strips (interior compute stays f32), halving the
ICI/DCN payload per exchange (halo_comm_bytes accounting), with halo
values rounding ONCE.  Reference counterpart: none (the reference is
single-process; SURVEY.md section 2.7).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
from jax.sharding import PartitionSpec as P

from gt4py_tpu.parallel import (
    CartesianMesh,
    halo_comm_bytes,
    halo_exchange,
    shard_map_stencil,
    to_extended,
)

BF16 = np.dtype(ml_dtypes.bfloat16)


def _exchange(cmesh, arr, h, wire):
    ext = to_extended(cmesh, arr, (h, h))

    def ex(b):
        return halo_exchange(b, (h, h), periodic=(True, True), wire_dtype=wire)

    spec = P("x", "y")
    return np.asarray(
        jax.shard_map(
            ex, mesh=cmesh.mesh, in_specs=(spec,), out_specs=spec,
            check_vma=False,
        )(ext)
    )


def test_wire_halves_payload_and_rounds_once():
    """Exchanged halo strips arrive bf16-rounded exactly once; interior
    content is untouched; payload accounting halves."""
    cmesh = CartesianMesh((2, 4))
    px, py = cmesh.shape
    h, ni_l, nj_l = 2, 8, 8
    rng = np.random.default_rng(5)
    arr = rng.random((px * ni_l, py * nj_l)).astype(np.float32)

    full = _exchange(cmesh, arr, h, None)
    wired = _exchange(cmesh, arr, h, jnp.bfloat16)

    ni_e, nj_e = ni_l + 2 * h, nj_l + 2 * h
    for bi in range(px):
        for bj in range(py):
            blk_f = full[bi * ni_e : (bi + 1) * ni_e, bj * nj_e : (bj + 1) * nj_e]
            blk_w = wired[bi * ni_e : (bi + 1) * ni_e, bj * nj_e : (bj + 1) * nj_e]
            # interior identical
            np.testing.assert_array_equal(
                blk_w[h:-h, h:-h], blk_f[h:-h, h:-h]
            )
            # halos are the full-precision halos rounded ONCE to bf16
            for sl in (
                (slice(0, h), slice(None)),
                (slice(-h, None), slice(None)),
                (slice(None), slice(0, h)),
                (slice(None), slice(-h, None)),
            ):
                np.testing.assert_array_equal(
                    blk_w[sl], blk_f[sl].astype(BF16).astype(np.float32)
                )

    assert halo_comm_bytes(
        (ni_e, nj_e), (h, h), np.float32, wire_dtype=BF16
    ) * 2 == halo_comm_bytes((ni_e, nj_e), (h, h), np.float32)


def test_wire_mesh_size_invariance():
    """A 1-sized mesh axis (wrap done locally) applies the same wire
    rounding as a real ppermute, so results are BITWISE independent of
    the mesh factorization."""
    h, NI, NJ = 1, 16, 16
    rng = np.random.default_rng(7)
    arr = rng.random((NI, NJ)).astype(np.float32)
    out_24 = _exchange(CartesianMesh((2, 4)), arr, h, jnp.bfloat16)
    out_81 = _exchange(CartesianMesh((8, 1)), arr, h, jnp.bfloat16)
    # compare the reassembled INTERIOR views (crop per-block halos)
    from gt4py_tpu.parallel import from_extended

    a = np.asarray(
        from_extended(CartesianMesh((2, 4)), jnp.asarray(out_24), (h, h))
    )
    b = np.asarray(
        from_extended(CartesianMesh((8, 1)), jnp.asarray(out_81), (h, h))
    )
    np.testing.assert_array_equal(a, b)


def test_sharded_stencil_step_with_bf16_wire():
    """A halo-dependent 5-point step through shard_map_stencil with
    halo_wire_dtype=bf16: equals the single-array reference computed
    with bf16-rounded halos (f32 interior compute)."""
    cmesh = CartesianMesh((2, 4))
    h = 1
    NI, NJ, NK = 16, 16, 3
    rng = np.random.default_rng(9)
    u0 = rng.random((NI, NJ, NK)).astype(np.float32)

    def lap(u):
        return (
            np.roll(u, -1, 0) + np.roll(u, 1, 0)
            + np.roll(u, -1, 1) + np.roll(u, 1, 1) - 4.0 * u
        )

    def stencil_fn(u):
        out = u[1:-1, 1:-1] * 0.0
        out = (
            u[2:, 1:-1] + u[:-2, 1:-1] + u[1:-1, 2:] + u[1:-1, :-2]
            - 4.0 * u[1:-1, 1:-1]
        )
        pad = [(1, 1), (1, 1)] + [(0, 0)] * (u.ndim - 2)
        import jax.numpy as jnp_

        return {"u": jnp_.pad(out, pad)}

    step = shard_map_stencil(
        stencil_fn,
        cmesh,
        (h, h),
        field_names=("u",),
        periodic=(True, True),
        halo_wire_dtype=jnp.bfloat16,
    )
    got = np.asarray(step(u=jnp.asarray(u0))["u"])

    # reference: per-block halos are bf16-rounded copies of the
    # neighbors' f32 edges; compute in f32.  Build it with the wire
    # exchange itself (already verified above) + local laplacian.
    ext = _exchange(cmesh, u0, h, jnp.bfloat16)
    px, py = cmesh.shape
    ni_e, nj_e = NI // px + 2 * h, NJ // py + 2 * h
    want = np.zeros_like(u0)
    for bi in range(px):
        for bj in range(py):
            blk = ext[bi * ni_e : (bi + 1) * ni_e, bj * nj_e : (bj + 1) * nj_e]
            res = (
                blk[2:, 1:-1] + blk[:-2, 1:-1] + blk[1:-1, 2:]
                + blk[1:-1, :-2] - 4.0 * blk[1:-1, 1:-1]
            )
            want[
                bi * (NI // px) : (bi + 1) * (NI // px),
                bj * (NJ // py) : (bj + 1) * (NJ // py),
            ] = res
    np.testing.assert_array_equal(got, want)

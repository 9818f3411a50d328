"""Sort-routing gathers for irregular tables (next/sort_route.py).

Contract: EXACT equality with the clipped-``take`` base path -- the
routing only MOVES values (seed permutation + doubling rounds +
residual take patch), so not even an ulp may differ.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

import gt4py_tpu.next as gtx
from gt4py_tpu.next import Dims, Field, FieldOffset, backends, neighbor_sum
from gt4py_tpu.next import affine_remap as ar
from gt4py_tpu.next import sort_route as sr
from gt4py_tpu.next.testing import (
    E2VDim,
    Edge,
    V2EDim,
    Vertex,
    shuffled_mesh,
)


def _take_ref(table, data, own_start=0):
    safe = np.clip(np.asarray(table).reshape(-1) - own_start, 0, data.shape[0] - 1)
    return np.take(np.asarray(data), safe, axis=0)


def _check_plan(table, M, skip=None, extra=(), seed=0):
    rng = np.random.default_rng(seed)
    plan = sr.build_gather_plan(table, skip)
    assert plan is not None
    data_np = rng.random((M,) + extra).astype(np.float32)
    got = sr.apply_gather_plan(plan, jnp.asarray(data_np), 0, 0)
    assert got is not None
    ref = _take_ref(table, data_np)
    assert np.array_equal(np.asarray(got), ref)
    return plan


def test_uniform_random_gather_exact():
    rng = np.random.default_rng(0)
    M, N = 65536, 262144
    plan = _check_plan(rng.integers(0, M, N).astype(np.int64), M)
    assert len(plan.keys) >= 2  # seed + doubling rounds


def test_two_column_table_and_skips():
    rng = np.random.default_rng(1)
    M, N = 65536, 262144
    _check_plan(rng.integers(0, M, (N // 2, 2)).astype(np.int64), M)
    t = rng.integers(0, M, (N // 4, 4)).astype(np.int64)
    t[rng.random(t.shape) < 0.05] = -1
    _check_plan(t, M, skip=-1)


def test_extra_data_axis():
    rng = np.random.default_rng(2)
    M, N = 65536, 131072
    _check_plan(rng.integers(0, M, N).astype(np.int64), M, extra=(3,))


def test_hub_entries_become_residuals():
    rng = np.random.default_rng(3)
    M, N = 65536, 262144
    t = rng.integers(0, M, N).astype(np.int64)
    t[: N // 50] = 7  # 2% hub: occurrence ranks beyond the cap
    plan = _check_plan(t, M)
    assert plan.res_pos.size > 0


def test_small_tables_decline():
    rng = np.random.default_rng(4)
    assert sr.build_gather_plan(rng.integers(0, 100, 1000), None) is None


def test_noncovering_domain_declines():
    rng = np.random.default_rng(5)
    M, N = 65536, 131072
    t = rng.integers(0, M, N).astype(np.int64)
    plan = sr.build_gather_plan(t, None)
    data = jnp.asarray(rng.random(M - 5).astype(np.float32))
    assert sr.apply_gather_plan(plan, data, 0, 0) is None


def test_shuffled_mesh_remap_and_reduction_bitwise():
    """The flagship: gradient+divergence on a SHUFFLED (irregular) mesh
    through jax_jit is bitwise equal to the numpy oracle; affine remap
    provably declines, the sort route engages."""
    mesh = shuffled_mesh(192, seed=7)
    assert ar.plan_for(mesh.e2v) is None
    assert ar.plan_for(mesh.v2e) is None

    E2V = FieldOffset("E2V", source=Vertex, target=(Edge, E2VDim))
    V2E = FieldOffset("V2E", source=Edge, target=(Vertex, V2EDim))

    @gtx.field_operator
    def gradient(
        psi: Field[Dims[Vertex], gtx.float32],
    ) -> Field[Dims[Edge], gtx.float32]:
        return psi(E2V[1]) - psi(E2V[0])

    @gtx.field_operator
    def divergence(
        flux: Field[Dims[Edge], gtx.float32],
        sign: Field[Dims[Vertex, V2EDim], gtx.float32],
    ) -> Field[Dims[Vertex], gtx.float32]:
        return neighbor_sum(flux(V2E) * sign, axis=V2EDim)

    provider = {"E2V": mesh.e2v, "V2E": mesh.v2e}
    t = np.asarray(mesh.v2e.table)
    first = np.asarray(mesh.e2v.table)[np.clip(t, 0, mesh.n_edges - 1), 0]
    sign_np = np.where(
        t == -1,
        0.0,
        np.where(first == np.arange(mesh.n_vertices)[:, None], 1.0, -1.0),
    ).astype(np.float32)
    psi_np = np.random.default_rng(3).random(mesh.n_vertices).astype(np.float32)

    def run(backend, wrap):
        psi = gtx.as_field((Vertex,), wrap(psi_np))
        sign = gtx.as_field((Vertex, V2EDim), wrap(sign_np))
        g = gradient.with_backend(backend)(psi, offset_provider=provider)
        d = divergence.with_backend(backend)(g, sign, offset_provider=provider)
        return np.asarray(d.asnumpy())

    ref = run(backends.numpy_oracle, np.asarray)
    got = run(backends.jax_jit, jnp.asarray)
    assert np.array_equal(got, ref)
    # the sort route must actually have engaged on the reduction gather
    assert mesh.v2e.__dict__.get("_sort_route_plan")[1] is not None


def test_env_kill_switch(monkeypatch):
    monkeypatch.setenv("GT4PY_TPU_SORT_GATHER", "0")
    mesh = shuffled_mesh(192, seed=1)
    assert sr.plan_for(mesh.v2e) is None


# ------------------------ static permutations ------------------------ #


@pytest.mark.parametrize("P", [512, 4096, 5000])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint32])
def test_static_permutation_exact(P, dtype):
    """The permutation executor moves values only: arbitrary bit
    patterns (NaN payloads, +-inf, -0.0, all-ones) survive exactly, at
    power-of-two and other sizes."""
    rng = np.random.default_rng(P)
    sigma = rng.permutation(P).astype(np.int64)
    keys = np.empty(P, dtype=np.int64)
    keys[sigma] = np.arange(P)
    x_np = rng.integers(0, 2**32, P, dtype=np.uint64).astype(np.uint32)
    x_np[:6] = np.array(
        [0x7F800001, 0x7FC00000, 0x7F800000, 0xFF800000, 0x80000000, 0xFFFFFFFF],
        dtype=np.uint32,
    )
    x_np = x_np.view(dtype)
    got = sr._permute(jnp.asarray(x_np), keys.astype(np.int32))
    assert got.dtype == dtype
    assert np.array_equal(np.asarray(got).view(np.uint32), x_np[sigma].view(np.uint32))


def test_middle_axis_gather():
    """Codomain on a non-leading axis (e.g. (K, Edge, comp) layouts)."""
    rng = np.random.default_rng(6)
    M, N = 65536, 131072
    t = rng.integers(0, M, N).astype(np.int64)
    plan = sr.build_gather_plan(t, None)
    data = rng.random((3, M, 2)).astype(np.float32)
    got = sr.apply_gather_plan(plan, jnp.asarray(data), 0, 1)
    ref = np.take(data, np.clip(t, 0, M - 1), axis=1)
    assert np.array_equal(np.asarray(got), ref)


@pytest.mark.parametrize("seed", range(10))
def test_gather_fuzz(seed):
    """Randomized table families vs the clipped-take semantics, bitwise
    (gt4py_tpu/testing/gather_fuzz.py; offline sweeps raise the count)."""
    from gt4py_tpu.testing.gather_fuzz import run_gather_case

    run_gather_case(seed)

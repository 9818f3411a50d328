"""Multi-hop gather composition (ROADMAP r5 queue #5).

Adjacent concrete connectivity hops in a multi-offset application
(``v(E2V0[0], V2E1[1])``) or ``premap`` fold into ONE composite gather:
``comp[x, ...] = t1[clip(t2[x]), ...]`` reproduces the two-hop base path
bit-for-bit (the intermediate always lives on ``[0, len(t1))`` with
clip-to-range semantics), and on quasi-structured meshes the composite
table refits affine, so the chain runs as dense strided windows with no
materialized intermediate.  Reference behavior: sequential premap
composition (src/gt4py/next/embedded/nd_array_field.py:240-376); the
folding itself is new here (XLA gathers are the cost being removed).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gt4py_tpu.next import affine_remap
from gt4py_tpu.next import common as C
from gt4py_tpu.next.testing import (
    E2VDim,
    Edge,
    V2EDim,
    Vertex,
    grid_mesh,
    shuffled_mesh,
)

E2V0 = C.FieldOffset("E2V", source=Vertex, target=(Edge, E2VDim))
V2E1 = C.FieldOffset("V2E", source=Edge, target=(Vertex, V2EDim))
E2V_full = C.FieldOffset("E2V", source=Vertex, target=(Edge, E2VDim))


def _vfield(mesh, seed=0, use_jax=True):
    rng = np.random.default_rng(seed)
    vv = rng.random(mesh.n_vertices)
    data = jnp.asarray(vv) if use_jax else vv
    return vv, C.Field(
        C.Domain((Vertex,), (C.UnitRange(0, mesh.n_vertices),)), data
    )


@pytest.mark.parametrize("mesh_fn", [grid_mesh, shuffled_mesh])
def test_indexed_chain_folds_and_matches(mesh_fn):
    """v(E2V0[0], V2E1[1]) == the sequential two-hop result, and the
    composite actually engages (cache populated)."""
    mesh = mesh_fn(64)
    vv, f = _vfield(mesh)
    with C.offset_provider_context({"E2V": mesh.e2v, "V2E": mesh.v2e}):
        seq = f(E2V0[0])(V2E1[1])          # separate calls: never folded
        one = f(E2V0[0], V2E1[1])          # folded
    assert np.array_equal(np.asarray(seq.data), np.asarray(one.data))
    assert [d.value for d in one.dims] == ["Vertex"]
    exp = vv[mesh.e2v.table[:, 0]][np.clip(mesh.v2e.table[:, 1], 0, None)]
    np.testing.assert_allclose(np.asarray(one.data), exp, rtol=1e-15)
    col1 = C._column_conn(mesh.v2e, 1)
    cache = col1.__dict__.get("_compose_cache")
    assert cache and any(v is not None for v in cache.values()), (
        "composite did not engage"
    )


def test_grid_mesh_composite_refits_affine():
    """On the structured mesh both hops are affine AND the composite
    refits affine: the whole chain is dense windows, no take."""
    mesh = grid_mesh(128)
    _, f = _vfield(mesh)
    with C.offset_provider_context({"E2V": mesh.e2v, "V2E": mesh.v2e}):
        f(E2V0[0], V2E1[1])
    col1 = C._column_conn(mesh.v2e, 1)
    comp = next(iter(col1.__dict__["_compose_cache"].values()))
    assert comp is not None
    assert affine_remap.plan_for(comp) is not None


def test_2d_then_1d_chain_folds():
    """A full 2D hop followed by an indexed 1D hop composes into one 2D
    gather carrying the local dim."""
    mesh = grid_mesh(48)
    vv, f = _vfield(mesh)
    with C.offset_provider_context({"E2V": mesh.e2v, "V2E": mesh.v2e}):
        seq = f(E2V_full)(V2E1[1])
        one = f(E2V_full, V2E1[1])
    assert np.array_equal(np.asarray(seq.data), np.asarray(one.data))
    assert [d.value for d in one.dims] == ["Vertex", "E2V"]


def test_premap_folds_connectivities():
    mesh = grid_mesh(48)
    vv, f = _vfield(mesh)
    c1 = C._column_conn(mesh.e2v, 0)
    c2 = C._column_conn(mesh.v2e, 1)
    seq = f.remap(c1).remap(c2)
    one = f.premap(c1, c2)
    assert np.array_equal(np.asarray(seq.data), np.asarray(one.data))


def test_triple_chain_folds_greedily():
    """Three hops fold left-to-right: ((c1.c2).c3) -- vertex -> edge ->
    vertex -> edge -> vertex round trips stay exact."""
    mesh = grid_mesh(48)
    vv, f = _vfield(mesh)
    with C.offset_provider_context({"E2V": mesh.e2v, "V2E": mesh.v2e}):
        seq = f(E2V0[0])(V2E1[1])(E2V0[1])
        one = f(E2V0[0], V2E1[1], E2V0[1])
    assert np.array_equal(np.asarray(seq.data), np.asarray(one.data))


def test_cartesian_shift_breaks_the_fold():
    """A cartesian shift between hops passes through untouched; the
    chain still evaluates correctly around it."""
    K = C.Dimension("K")
    mesh = grid_mesh(32)
    rng = np.random.default_rng(3)
    nv, nk = mesh.n_vertices, 5
    data = rng.random((nv, nk))
    f = C.Field(
        C.Domain((Vertex, K), (C.UnitRange(0, nv), C.UnitRange(0, nk))),
        jnp.asarray(data),
    )
    KOff = C.FieldOffset("KOff", source=K, target=(K,))
    with C.offset_provider_context(
        {"E2V": mesh.e2v, "V2E": mesh.v2e, "KOff": K}
    ):
        seq = f(E2V0[0])(KOff[1])(V2E1[1])
        one = f(E2V0[0], KOff[1], V2E1[1])
    assert np.array_equal(np.asarray(seq.data), np.asarray(one.data))


def test_numpy_oracle_path_unchanged():
    """The numpy-backed field (the oracle) also folds and stays exact."""
    mesh = grid_mesh(48)
    vv, f = _vfield(mesh, use_jax=False)
    with C.offset_provider_context({"E2V": mesh.e2v, "V2E": mesh.v2e}):
        one = f(E2V0[0], V2E1[1])
    exp = vv[mesh.e2v.table[:, 0]][np.clip(mesh.v2e.table[:, 1], 0, None)]
    np.testing.assert_allclose(np.asarray(one.data), exp, rtol=1e-15)


def test_replaced_table_rekeys_compose_cache():
    """Replacing a table invalidates stale composites (token re-key)."""
    mesh = grid_mesh(48)
    vv, f = _vfield(mesh)
    with C.offset_provider_context({"E2V": mesh.e2v, "V2E": mesh.v2e}):
        a = f(E2V0[0], V2E1[1])
        # replace e2v with a table gathering the OTHER endpoint
        new_table = mesh.e2v.table[:, ::-1].copy()
        mesh.e2v.table = new_table
        b = f(E2V0[0], V2E1[1])
    exp_b = vv[new_table[:, 0]][np.clip(mesh.v2e.table[:, 1], 0, None)]
    np.testing.assert_allclose(np.asarray(b.data), exp_b, rtol=1e-15)
    assert not np.array_equal(np.asarray(a.data), np.asarray(b.data))


@pytest.mark.parametrize("seed", range(12))
def test_chain_fuzz(seed):
    """Differential chain-composition fuzz (12 CI seeds; offline sweeps
    raise the count -- 260 seeds clean at bring-up, 198 composed / 2
    cost-guard-sequential in the 200-seed sweep)."""
    from gt4py_tpu.testing.gather_fuzz import run_chain_case

    run_chain_case(seed)

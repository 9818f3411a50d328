"""Serialized PARALLEL K + plane-local temps, and the column kernel's own
plan for the same stencils.

``passes.serialize_parallel_k`` rewrites PARALLEL vertical loops to
FORWARD -- bitwise-identical whenever no same-loop-written field is read
at a nonzero K offset (guaranteed by the GTIR race rules, re-checked for
raw IR) -- and ``passes.plane_local_temps`` classifies temporaries whose
storage can be a single K plane.  Both are pure IR rewrites; the column
kernel must give the same numbers on the rewritten IR.  The kernel's own
planner keeps such temporaries as plane values (``LAST_PLAN["values"]``).

Reference analog: OIR LocalTemporariesToScalars + K-caches
(src/gt4py/cartesian/gtc/passes/oir_optimizations/{temporaries,caches}.py).
"""

import copy

import numpy as np
import pytest

from gt4py_tpu.cartesian import gtscript, ir, passes
from gt4py_tpu.cartesian.analysis import analyze
from gt4py_tpu.cartesian.backend import pallas_backend
from gt4py_tpu.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    computation,
    interval,
)

F = gtscript.Field[np.float64]

pytestmark = pytest.mark.usefixtures("all_kernel_classes")


def _backend_of(stencil_obj):
    return pallas_backend.PallasBackend(stencil_obj.analysis, {})


# --------------------------------------------------------------------- #
# serialize_parallel_k classifier
# --------------------------------------------------------------------- #


def test_serialize_mixed_stencil():
    @gtscript.stencil(backend="pallas", name="ser_mixed")
    def mixed(a: F, out: F):
        with computation(PARALLEL), interval(...):
            t = a[1, 0, 0] + a[-1, 0, 0]
        with computation(FORWARD):
            with interval(0, 1):
                acc = t
                out = acc
            with interval(1, None):
                acc = acc[0, 0, -1] + t
                out = acc

    ser = passes.serialize_parallel_k(mixed.analysis.stencil)
    assert ser is not None
    assert all(
        vl.loop_order != ir.LoopOrder.PARALLEL for vl in ser.vertical_loops
    )
    assert ser.name.endswith("__serK")
    # the original is untouched
    assert any(
        vl.loop_order == ir.LoopOrder.PARALLEL
        for vl in mixed.analysis.stencil.vertical_loops
    )


def test_serialize_declines_k_offset_read_of_written():
    """Raw IR violating the PARALLEL race rule (read of a same-loop
    write at K!=0) must not serialize -- plane order would change it."""

    @gtscript.stencil(backend="pallas", name="ser_safe")
    def safe(a: F, out: F):
        with computation(PARALLEL), interval(...):
            t = a * 2.0
            out = t

    st = copy.deepcopy(safe.analysis.stencil)
    # corrupt: make the read of t a K-offset read inside the same loop
    stmt = st.vertical_loops[0].sections[0].body[1]
    assert isinstance(stmt, ir.Assign)
    stmt.value = ir.FieldAccess(name="t", offset=ir.CartesianOffset(0, 0, 1))
    assert passes.serialize_parallel_k(st) is None


def test_serialize_declines_runtime_intervals():
    @gtscript.stencil(backend="pallas", name="ser_rt")
    def rt(a: F, out: F, *, kmid: np.int64):
        with computation(PARALLEL):
            with interval(0, kmid):
                out = a * 2.0
            with interval(kmid, None):
                out = a * 3.0

    assert passes.serialize_parallel_k(rt.analysis.stencil) is None


def test_serialize_nothing_to_do():
    @gtscript.stencil(backend="pallas", name="ser_allserial")
    def allserial(a: F, out: F):
        with computation(FORWARD), interval(...):
            out = a * 2.0

    assert passes.serialize_parallel_k(allserial.analysis.stencil) is None


# --------------------------------------------------------------------- #
# plane_local_temps classifier
# --------------------------------------------------------------------- #


def test_vadv_plane_temps():
    """The tridiagonal solve's per-plane coefficients are plane-local;
    the K-carried/cross-loop columns are not."""
    from gt4py_tpu.models.dycore import make_vadv_update

    st = make_vadv_update(np.float32, backend="pallas")
    pt = passes.plane_local_temps(st.analysis.stencil)
    assert {"gcv", "cs", "bcol", "divided", "correction_term"} <= pt
    assert not {"ccol", "dcol", "datacol"} & pt


def test_plane_local_requires_write_first():
    @gtscript.stencil(backend="pallas", name="pl_rbw")
    def rbw(a: F, out: F, out2: F):
        with computation(FORWARD):
            with interval(0, 1):
                t = a
                out = t
            with interval(1, None):
                out = t          # read with NO write in this section
                t = a * 2.0
                out2 = t

    pt = passes.plane_local_temps(rbw.analysis.stencil)
    assert "t" not in pt


def test_plane_local_requires_unconditional_write():
    @gtscript.stencil(backend="pallas", name="pl_cond")
    def cond(a: F, out: F):
        with computation(FORWARD), interval(...):
            t = 0.0
            if a > 0.5:
                t = a
            out = t
            u = 0.0
            if a > 0.5:
                u = a * 2.0
            out = out + u

    pt = passes.plane_local_temps(cond.analysis.stencil)
    # t and u ARE plane-local: the first touch is the unconditional init
    assert {"t", "u"} <= pt

    # but a conditional FIRST write is not
    st = copy.deepcopy(cond.analysis.stencil)
    sec = st.vertical_loops[0].sections[0]
    sec.body = [s for s in sec.body if not (
        isinstance(s, ir.Assign) and s.target.name == "t"
        and isinstance(s.value, ir.Literal)
    )]
    pt2 = passes.plane_local_temps(st)
    assert "t" not in pt2


def test_plane_local_excludes_parallel_and_k_offset():
    @gtscript.stencil(backend="pallas", name="pl_par")
    def par(a: F, out: F, out2: F):
        with computation(PARALLEL), interval(...):
            p = a * 2.0
            out = p
        with computation(FORWARD):
            with interval(0, 1):
                c = a
                out2 = c
            with interval(1, None):
                c = c[0, 0, -1] + a   # K carry
                out2 = c

    pt = passes.plane_local_temps(par.analysis.stencil)
    assert "p" not in pt     # parallel-loop temp
    assert "c" not in pt     # K-offset carry


# --------------------------------------------------------------------- #
# numeric parity (interpret-mode kernels, CPU)
# --------------------------------------------------------------------- #


def _run_pair(stencil_obj_pallas, stencil_obj_numpy, shape, domain, origin,
              seed=0, scalars=()):
    rng = np.random.default_rng(seed)
    arrays = {}
    for p in stencil_obj_pallas.analysis.stencil.field_decls:
        arrays[p] = rng.random(shape)
    kw_np = {k: v.copy() for k, v in arrays.items()}
    kw_pl = {k: v.copy() for k, v in arrays.items()}
    sc = dict(scalars)
    stencil_obj_numpy(**kw_np, **sc, origin=origin, domain=domain)
    stencil_obj_pallas(**kw_pl, **sc, origin=origin, domain=domain)
    return kw_np, kw_pl


def _run_ir(stencil, arrays, domain, origin, scalars=None):
    """Run raw IR through the pallas backend (every class to the kernel)."""
    be = pallas_backend.PallasBackend(analyze(stencil), {})
    out = be.run(
        {k: v.copy() for k, v in arrays.items()}, dict(scalars or {}), domain,
        {k: origin for k in arrays},
    )
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("force", [False, True])
def test_mixed_stencil_parity_serialized(force):
    """numpy oracle vs the kernel on the stencil and on its serialized
    form: rtol 1e-12 f64 (the serialized form must be bitwise-equal to
    the parallel evaluation; both sit at oracle parity)."""

    def defn(a: F, b: F, out: F):
        with computation(PARALLEL), interval(...):
            lap = a[1, 0, 0] + a[-1, 0, 0] + a[0, 1, 0] + a[0, -1, 0] - 4.0 * a
            flx = lap[1, 0, 0] - lap[0, 0, 0]
        with computation(FORWARD):
            with interval(0, 1):
                acc = flx + b
                out = acc
            with interval(1, None):
                acc = acc[0, 0, -1] * 0.5 + flx
                out = acc
        with computation(BACKWARD):
            with interval(0, -1):
                out = out + out[0, 0, 1] * 0.25

    name = f"ser_parity_{force}"
    st_n = gtscript.stencil(backend="numpy", name=name + "_np")(defn)
    stencil = st_n.analysis.stencil
    if force:
        stencil = passes.serialize_parallel_k(stencil)
        assert stencil is not None

    shape, domain, origin = (16, 14, 9), (8, 6, 7), (4, 4, 1)
    rng = np.random.default_rng(0)
    arrays = {p: rng.random(shape) for p in st_n.analysis.stencil.field_decls}
    ref = {k: v.copy() for k, v in arrays.items()}
    st_n(**ref, origin=origin, domain=domain)
    got = _run_ir(stencil, arrays, domain, origin)
    np.testing.assert_allclose(got["out"], ref["out"], rtol=1e-12, atol=1e-12)


def test_fused_dycore_serialized_bitwise_vs_baseline():
    """The fused whole-dycore stencil through the kernel: its serialized
    form is BITWISE equal to the parallel one."""
    from gt4py_tpu.models import dycore

    md = dycore.MiniDycore(16, 24, 8, backend="jax")
    st = md.fused.analysis.stencil
    ser = passes.serialize_parallel_k(st)
    assert ser is not None
    state = md.init_state(seed=5)
    arrays = {
        n: np.transpose(state.get(n, state["u"]), (1, 2, 0)).copy()
        for n in st.field_decls
    }
    origin = (md.oi, md.oj, 0)
    sc = {"dtr_stage": np.float32(3.0)}
    before = pallas_backend.FALLBACK_EVENTS.total
    base = _run_ir(st, arrays, (16, 24, 8), origin, sc)
    assert pallas_backend.FALLBACK_EVENTS.total == before
    out = _run_ir(ser, arrays, (16, 24, 8), origin, sc)
    for k in base:
        assert np.array_equal(base[k], out[k]), k


# --------------------------------------------------------------------- #
# the column kernel's plan at bench scale (pure planning, no tracing)
# --------------------------------------------------------------------- #


def _bench_metas(md, be):
    state = {k: np.asarray(v) for k, v in md.init_state().items()}
    arrays = dict(
        u=state["u"], coeff=state["coeff"], wcon=state["wcon"],
        utens=state["utens"], utens_stage=state["utens_stage"],
        u_out=state["u"].copy(),
    )
    orig = (md.oi, md.oj, 0)
    metas, _ = be._prepare(
        arrays, {k: orig for k in arrays}, as_device=False, physical_in=True
    )
    return metas


def test_fused_dycore_plans_serialized_at_bench_scale():
    """512^2x80: the fused dycore plans as ONE launch of serial sweeps;
    blocks of 8 x 64 points (256 B rows of f32)."""
    from gt4py_tpu.models import dycore

    md = dycore.MiniDycore(512, 512, 80, backend="pallas")
    be = md.fused.backend
    stages, values, carries, blocks = be.plan(
        _bench_metas(md, be), (512, 512, 80)
    )
    assert len(stages) >= 1
    assert any(sw.order != ir.LoopOrder.PARALLEL for st in stages for sw in st.sweeps)
    assert all((b.bi, b.bj) == (8, 64) for b in blocks), blocks


def test_vadv_plane_temps_unlock_larger_tiles():
    """The bench vadv kernel keeps the per-plane coefficients as plane
    values (no device-memory traffic), the same set the plane-local pass
    finds, and carries the recurrence columns."""
    from gt4py_tpu.models import dycore

    md = dycore.MiniDycore(512, 512, 80, backend="pallas")
    be = md.vadv_upd.backend
    state = {k: np.asarray(v) for k, v in md.init_state().items()}
    arrays = dict(
        utens_stage=state["utens_stage"], u_stage=state["u"],
        wcon=state["wcon"], u_pos=state["u"].copy(),
        utens=state["utens"], u_out=state["u"].copy(),
    )
    orig = (md.oi, md.oj, 0)
    metas, _ = be._prepare(
        arrays, {k: orig for k in arrays}, as_device=False, physical_in=True
    )
    stages, values, carries, blocks = be.plan(metas, (512, 512, 80))
    assert {"gcv", "cs", "bcol", "divided", "correction_term"} <= values
    assert [(b.bi, b.bj) for b in blocks] == [(8, 64)] * len(stages)

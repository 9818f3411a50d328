"""Temporaries in the column kernel: plane values, carries and device
memory.

A temporary read only at its own point (or, in a serial sweep, at planes
behind the sweep) stays an SSA value of the plane and never touches
device memory; one read at a horizontal offset after its write lives in
device memory between launches (stages).  These tests pin the classifier
(``LAST_PLAN`` / ``PallasBackend.plan``) and numeric parity for the
trickier write forms (partial-interval cover, masked writes under
regions) in interpret mode; tests/test_gpu.py drives the same kernels on
the card.
"""

import numpy as np
import pytest

from gt4py_tpu.cartesian import gtscript
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


def _plan(be, n=(32, 24, 6), scalars=None):
    from gt4py_tpu.cartesian.backend.jax_backend import _FieldMeta

    metas = {
        f: _FieldMeta((n[0] + 6, n[1] + 6, n[2]), (3, 3, 0),
                      np.dtype(np.float32), (True, True, True), 0)
        for f in be.analysis.stencil.field_decls
    }
    return be.plan(metas, n, scalars or {})


def test_fv_step_temps_all_value_eligible():
    """Every FV temporary that survives inlining is read at a horizontal
    offset, so it lives in device memory between launches: none may be a
    plane value (a plane value would read a neighbour block's point)."""
    from gt4py_tpu.cartesian.backend.pallas_backend import _accesses, _hoff
    from gt4py_tpu.models.fv_advection import make_fv_step

    be = _backend_of(make_fv_step(np.float32, backend="pallas"))
    temps = set(be.analysis.stencil.temp_decls)
    assert temps, "fv_step lost its temporaries?"
    stages, values, _, _ = _plan(be)
    reads, _ = _accesses(
        [s for st in stages for sw in st.sweeps for s in sw.stmts]
    )
    shifted = {r.name for r in reads if _hoff(r)}
    assert temps <= shifted and not values & temps


def test_liveness_peak_below_sum():
    """FV's launches split only where a horizontal read needs another
    block's write: fewer launches than temporaries, one sweep each."""
    from gt4py_tpu.models.fv_advection import make_fv_step

    be = _backend_of(make_fv_step(np.float32, backend="pallas"))
    stages, _, _, _ = _plan(be)
    assert 1 < len(stages) < len(be.analysis.stencil.temp_decls)
    assert all(len(st.sweeps) == 1 for st in stages)


def test_serial_and_while_temps_stay_refs():
    @gtscript.stencil(backend="pallas", name="vt_cls")
    def mixed(a: F, out: F, out2: F):
        with computation(PARALLEL), interval(...):
            ptmp = a * 2.0          # value-eligible
            wtmp = a
            while wtmp < 1.0:       # while-written: must stay a ref
                wtmp = wtmp + 0.5
            out = ptmp + wtmp
        with computation(FORWARD):
            with interval(0, 1):
                stmp = a            # serial-section temp: ref
                out2 = stmp
            with interval(1, None):
                stmp = stmp[0, 0, -1] + a
                out2 = stmp

    be = _backend_of(mixed)
    _, vts, carries, _ = _plan(be)
    temps = set(be.analysis.stencil.temp_decls)
    # ptmp is inlined into its reader; the while loop carries wtmp's
    # plane value; stmp crosses two sweeps with a carry: device memory
    assert "wtmp" in vts
    stmps = [t for t in temps if t.startswith("stmp")]
    assert stmps and not any(t in vts for t in stmps)
    assert any(t in c for c in carries.values() for t in stmps)


@pytest.mark.parametrize("shape", [(10, 11, 6)])
def test_partial_interval_value_temp_parity(shape):
    # the temp's single write covers only part of its K range: the
    # zeros+update path must reproduce zero-initialized scratch semantics
    def defn(a: F, out: F):
        with computation(PARALLEL):
            with interval(1, -2):
                t = a * 3.0 + a[1, 0, 0]
            with interval(...):
                out = a
        with computation(PARALLEL), interval(1, -2):
            out = t + t[0, 1, 0]

    res = {}
    for be in ("numpy", "pallas"):
        st = gtscript.stencil(backend=be, name=f"vt_part_{be}")(defn)
        rng = np.random.default_rng(3)
        a = rng.random(shape)
        out = np.zeros(shape)
        before = len(pallas_backend.FALLBACK_EVENTS)
        st(a, out, domain=(shape[0] - 1, shape[1] - 1, shape[2]))
        if be == "pallas":
            assert not pallas_backend.FALLBACK_EVENTS[before:]
        res[be] = out
    np.testing.assert_allclose(res["pallas"], res["numpy"], rtol=1e-12)


def test_region_masked_value_temp_parity():
    # single write under a horizontal region: masked write over the
    # zeros "old" region
    from gt4py_tpu.cartesian.gtscript import I, horizontal, region

    def defn(a: F, out: F):
        with computation(PARALLEL), interval(...):
            with horizontal(region[I[0] : I[4], :]):
                t = a * 4.0
                out = t + t[1, 0, 0]

    res = {}
    for be in ("numpy", "pallas"):
        st = gtscript.stencil(backend=be, name=f"vt_if_{be}")(defn)
        rng = np.random.default_rng(4)
        a = rng.random((9, 8, 5))
        out = np.zeros((9, 8, 5))
        before = len(pallas_backend.FALLBACK_EVENTS)
        st(a, out, domain=(8, 8, 5))
        if be == "pallas":
            assert not pallas_backend.FALLBACK_EVENTS[before:]
        res[be] = out
    np.testing.assert_allclose(res["pallas"], res["numpy"], rtol=1e-12)


def test_forced_mosaic_value_temps():
    """A temporary read at an offset after inlining is off: the kernel
    splits into two launches and matches the oracle."""

    def defn(a: F, out: F):
        with computation(PARALLEL), interval(...):
            lap = a[1, 0, 0] + a[-1, 0, 0] + a[0, 1, 0] + a[0, -1, 0] - 4.0 * a
            out = lap[1, 0, 0] - lap

    st_p = gtscript.stencil(backend="pallas", name="vt_split_p", no_inline=True)(defn)
    st_n = gtscript.stencil(backend="numpy", name="vt_split_n")(defn)
    rng = np.random.default_rng(5)
    a = rng.random((12, 12, 4))
    op = np.zeros((12, 12, 4))
    on = np.zeros((12, 12, 4))
    st_p(a.copy(), op, origin=(2, 2, 0), domain=(8, 8, 4))
    st_n(a.copy(), on, origin=(2, 2, 0), domain=(8, 8, 4))
    assert pallas_backend.LAST_PLAN["vt_split_p"]["stages"] == 2
    np.testing.assert_allclose(op, on, rtol=1e-12)

"""Deep-K serial scans in the column kernel.

Each program walks the whole column in one in-kernel K loop, whatever
its depth: the planes a FORWARD/BACKWARD sweep reads behind itself are
loop carries (the K-cache), temporaries crossing loops live in device
memory, and a PARALLEL statement reading a sibling's output at a K offset
starts a new sweep.  These run in interpret mode on the CPU; the card
runs the same kernels (tests/test_gpu.py, chip_smoke.py).

Reference analog: FillFlushToLocalKCaches
(src/gt4py/cartesian/gtc/passes/oir_optimizations/caches.py:256).
"""

import numpy as np
import pytest

from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.backend import pallas_backend
from gt4py_tpu.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    K,
    computation,
    interval,
)

F = gtscript.Field[np.float64]

pytestmark = pytest.mark.usefixtures("all_kernel_classes")

_SEQ = 0


def _run_pair(defn, args0, *, domain, origin=(0, 0, 0)):
    """Run ``defn`` on numpy and pallas; assert the pallas run took the
    kernel with zero XLA fallbacks and matches the oracle."""
    global _SEQ
    _SEQ += 1
    res = {}
    for be in ("numpy", "pallas"):
        st = gtscript.stencil(backend=be, name=f"kb{_SEQ}_{be}")(defn)
        a = {k: v.copy() for k, v in args0.items()}
        before = len(pallas_backend.FALLBACK_EVENTS)
        st(**a, origin=origin, domain=domain)
        if be == "pallas":
            events = pallas_backend.FALLBACK_EVENTS[before:]
            assert not events, f"pallas fell back to XLA: {events}"
            assert f"kb{_SEQ}_{be}" in pallas_backend.LAST_PLAN
        res[be] = a
    for k in args0:
        np.testing.assert_allclose(
            res["pallas"][k], res["numpy"][k], rtol=1e-12, atol=0,
            err_msg=f"field {k}",
        )
    return pallas_backend.LAST_PLAN.get(f"kb{_SEQ}_pallas")


def _mk(shape, seed, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return lo + (hi - lo) * rng.random(shape)


def test_tridiagonal_dk512_runs_kblocked():
    """dK = 512 in one launch: four sweeps, carries for the recurrences."""

    def tridiag(inf: F, diag: F, sup: F, rhs: F, out: F):
        with computation(FORWARD):
            with interval(0, 1):
                sup = sup / diag
                rhs = rhs / diag
            with interval(1, None):
                sup = sup / (diag - sup[0, 0, -1] * inf)
                rhs = (rhs - inf * rhs[0, 0, -1]) / (diag - sup[0, 0, -1] * inf)
        with computation(BACKWARD):
            with interval(-1, None):
                out = rhs
            with interval(0, -1):
                out = rhs - sup * out[0, 0, 1]

    shape = (12, 12, 512)
    args = dict(
        inf=_mk(shape, 1, -0.3, 0.0),
        diag=_mk(shape, 2, 2.0, 3.0),
        sup=_mk(shape, 3, -0.3, 0.0),
        rhs=_mk(shape, 4),
        out=np.zeros(shape),
    )
    plan = _run_pair(
        tridiag, args, domain=(8, 8, 512), origin=(2, 2, 0)
    )
    assert plan["stages"] == 1 and len(plan["sweeps"][0]) == 4, plan
    assert plan["carries"] == ["out", "rhs", "sup"], plan


def test_promoted_cross_loop_temporary():
    # tmp is written in the FORWARD loop and read in the BACKWARD loop: it
    # lives in device memory, not as a plane value.
    def two_pass(a: F, out: F):
        with computation(FORWARD):
            with interval(0, 1):
                tmp = a
            with interval(1, None):
                tmp = tmp[0, 0, -1] * 0.5 + a
        with computation(BACKWARD):
            with interval(-1, None):
                out = tmp
            with interval(0, -1):
                out = tmp + 0.25 * out[0, 0, 1]

    shape = (10, 10, 512)
    args = dict(a=_mk(shape, 7), out=np.zeros(shape))
    plan = _run_pair(two_pass, args, domain=shape)
    assert "tmp" not in plan["values"] and "tmp" in plan["carries"], plan
    assert plan["stages"] == 1


def test_axis_position_rebases_across_blocks():
    # bare K in an expression is AxisPosition: the in-kernel loop index
    # must be the global level in every section.
    def with_k(a: F, out: F):
        with computation(FORWARD):
            with interval(0, 1):
                out = a * K
            with interval(1, None):
                out = out[0, 0, -1] + a * K

    shape = (9, 9, 600)
    args = dict(a=_mk(shape, 11), out=np.zeros(shape))
    _run_pair(with_k, args, domain=shape)


def test_non_power_of_two_depth():
    # dK=2000: a long carry chain in one loop.
    def cumsum(a: F, out: F):
        with computation(FORWARD):
            with interval(0, 1):
                out = a
            with interval(1, None):
                out = out[0, 0, -1] + a

    shape = (8, 8, 2000)
    args = dict(a=_mk(shape, 13), out=np.zeros(shape))
    _run_pair(cumsum, args, domain=shape)


def test_sections_crossing_block_boundaries():
    # consecutive sections are consecutive sweeps: the carry crosses each
    # section edge through device memory without dropping a plane.
    def staged(a: F, out: F):
        with computation(FORWARD):
            with interval(0, 1):
                out = a
            with interval(1, 700):
                out = out[0, 0, -1] + a
            with interval(700, -3):
                out = out[0, 0, -1] + 2.0 * a
            with interval(-3, None):
                out = out[0, 0, -1] - a

    shape = (8, 8, 2048)
    args = dict(a=_mk(shape, 17), out=np.zeros(shape))
    _run_pair(staged, args, domain=shape)


def test_backward_only_deep_scan():
    def back(a: F, out: F):
        with computation(BACKWARD):
            with interval(-1, None):
                out = a
            with interval(0, -1):
                out = 0.5 * out[0, 0, 1] + a

    shape = (8, 8, 2048)
    args = dict(a=_mk(shape, 19), out=np.zeros(shape))
    plan = _run_pair(back, args, domain=shape)
    assert [sw[0] for sw in plan["sweeps"][0]] == ["BACKWARD", "BACKWARD"]


def test_shallow_k_does_not_use_kblocked():
    # control: a shallow scan takes the same single-launch form.
    def cumsum(a: F, out: F):
        with computation(FORWARD):
            with interval(0, 1):
                out = a
            with interval(1, None):
                out = out[0, 0, -1] + a

    shape = (16, 16, 16)
    args = dict(a=_mk(shape, 23), out=np.zeros(shape))
    plan = _run_pair(cumsum, args, domain=shape)
    assert plan["stages"] == 1 and plan["carries"] == ["out"], plan


def test_parallel_cross_statement_k_dependency():
    """Regression (round-3 review): a PARALLEL statement reading a
    sibling statement's output at a K offset must see the fully-updated
    planes: the K-offset read of a sibling's output starts a new sweep."""
    def two_stmt(inp: F, out: F):
        with computation(PARALLEL):
            with interval(0, -1):
                tmp = inp * 2.0
            with interval(0, -1):
                out = tmp[0, 0, 1]

    shape = (12, 12, 512)
    args = dict(inp=_mk(shape, 29), out=np.zeros(shape))
    plan = _run_pair(two_stmt, args, domain=shape)
    assert len(plan["sweeps"][0]) == 2 and "tmp" not in plan["values"], plan

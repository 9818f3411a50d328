"""The pallas kernel path must cover the language, not silently fall back.

Reference counterpart: the per-backend feature matrices of
tests/next_tests/definitions.py:92-120 -- but here unsupported features
fall back to the XLA executor *transparently*, so a bitwise-equal result
cannot distinguish the paths.  These tests assert via
``pallas_backend.FALLBACK_EVENTS`` that the features in
``tests.definitions.NATIVE_SUPPORT["pallas"]`` really execute in-kernel
(interpret mode here; tests/test_gpu.py runs kernels on the card).
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

# kernel numerics for every stencil class, not only the default rule's
pytestmark = pytest.mark.usefixtures("all_kernel_classes")

F32 = gtscript.Field[np.float32]
I32 = gtscript.Field[np.int32]


def _assert_no_fallback(fn, *args, **kwargs):
    before = len(pallas_backend.FALLBACK_EVENTS)
    fn(*args, **kwargs)
    events = pallas_backend.FALLBACK_EVENTS[before:]
    assert not events, f"pallas fell back to XLA: {events}"


def _mk(shape, seed=0, dtype=np.float32, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return (lo + (hi - lo) * rng.random(shape)).astype(dtype)


def test_variable_k_offset_runs_in_kernel():
    @gtscript.stencil(backend="pallas")
    def varK(a: F32, kidx: I32, out: F32):
        with computation(PARALLEL), interval(...):
            out = a[0, 0, kidx] + a[1, 0, 0]

    @gtscript.stencil(backend="numpy")
    def varK_np(a: F32, kidx: I32, out: F32):
        with computation(PARALLEL), interval(...):
            out = a[0, 0, kidx] + a[1, 0, 0]

    shape = (13, 11, 9)
    rng = np.random.default_rng(1)
    a = _mk(shape, 1)
    kidx = rng.integers(-4, 5, shape).astype(np.int32)
    out_p = np.zeros(shape, np.float32)
    out_n = np.zeros(shape, np.float32)
    dom = (12, 11, 9)
    _assert_no_fallback(varK, a.copy(), kidx.copy(), out_p, domain=dom)
    varK_np(a.copy(), kidx.copy(), out_n, domain=dom)
    np.testing.assert_array_equal(out_p, out_n)


def test_absolute_k_in_scan_runs_in_kernel():
    @gtscript.stencil(backend="pallas")
    def absK(a: F32, out: F32):
        with computation(FORWARD):
            with interval(0, 1):
                out = a.at(K=3)
            with interval(1, None):
                out = a.at(K=0) + out[0, 0, -1]

    @gtscript.stencil(backend="numpy")
    def absK_np(a: F32, out: F32):
        with computation(FORWARD):
            with interval(0, 1):
                out = a.at(K=3)
            with interval(1, None):
                out = a.at(K=0) + out[0, 0, -1]

    shape = (7, 9, 8)
    a = _mk(shape, 2)
    out_p = np.zeros(shape, np.float32)
    out_n = np.zeros(shape, np.float32)
    _assert_no_fallback(absK, a.copy(), out_p)
    absK_np(a.copy(), out_n)
    np.testing.assert_array_equal(out_p, out_n)


def test_data_dims_split_runs_in_kernel():
    """Statically-indexed data-dims fields run as per-component column
    kernels (passes.split_data_dims); bitwise vs the jax executor."""

    def defn(
        vec: gtscript.Field[(np.float32, (3,))],
        out: F32,
        w: gtscript.Field[(np.float32, (2, 2))],
    ):
        with computation(PARALLEL), interval(...):
            out = vec[0, 0, 0][0] + vec[1, 0, 0][1] * vec[0, 0, 0][2]
            w[0, 0, 0][1, 0] = out[0, 0, 0] * 2.0
            w[0, 0, 0][0, 1] = vec[0, 0, 0][-1]

    st_p = gtscript.stencil(backend="pallas", definition=defn, rebuild=True)
    st_j = gtscript.stencil(backend="jax", definition=defn, rebuild=True)

    shape3 = (6, 5, 4)
    rng = np.random.default_rng(9)
    vec = rng.random(shape3 + (3,)).astype(np.float32)
    w = np.zeros(shape3 + (2, 2), np.float32)
    out = np.zeros(shape3, np.float32)
    vj, wj, oj = vec.copy(), w.copy(), out.copy()
    _assert_no_fallback(st_p, vec, out, w, origin=(1, 0, 0), domain=(4, 5, 4))
    st_j(vj, oj, wj, origin=(1, 0, 0), domain=(4, 5, 4))
    np.testing.assert_array_equal(out, oj)
    np.testing.assert_array_equal(w, wj)


def test_variable_k_in_backward_scan_runs_in_kernel():
    @gtscript.stencil(backend="pallas")
    def vscan(a: F32, kidx: I32, acc: F32):
        with computation(BACKWARD), interval(...):
            acc = a[0, 0, kidx] + acc[0, 0, 1] * 0.5

    @gtscript.stencil(backend="numpy")
    def vscan_np(a: F32, kidx: I32, acc: F32):
        with computation(BACKWARD), interval(...):
            acc = a[0, 0, kidx] + acc[0, 0, 1] * 0.5

    shape = (6, 7, 10)
    rng = np.random.default_rng(5)
    a = _mk(shape, 3)
    kidx = rng.integers(-9, 10, shape).astype(np.int32)
    acc_p = np.zeros(shape, np.float32)
    acc_n = np.zeros(shape, np.float32)
    dom = (6, 7, 9)  # leave the top plane as the carry seed
    _assert_no_fallback(vscan, a.copy(), kidx.copy(), acc_p, domain=dom)
    vscan_np(a.copy(), kidx.copy(), acc_n, domain=dom)
    np.testing.assert_array_equal(acc_p, acc_n)


def test_dynamic_data_index_runs_in_kernel():
    """Per-point data indices expand to component selects / masked
    per-component writes inside the kernel (no XLA fallback)."""
    def defn(vec: gtscript.Field[(np.float32, (3,))], idx: I32, a: F32, out: F32):
        with computation(PARALLEL), interval(...):
            out = vec[0, 0, 0][idx % 3] + a[1, 0, 0]
            vec[0, 0, 0][(idx + 1) % 3] = a * 2.0

    st_p = gtscript.stencil(backend="pallas", definition=defn, rebuild=True)
    st_n = gtscript.stencil(backend="numpy", definition=defn, rebuild=True)

    rng = np.random.default_rng(0)
    shape = (6, 5, 4)
    vec0 = rng.random(shape + (3,)).astype(np.float32)
    idx0 = rng.integers(-5, 6, shape).astype(np.int32)
    a0 = rng.random(shape).astype(np.float32)
    vp, vn = vec0.copy(), vec0.copy()
    op, on = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    _assert_no_fallback(
        st_p, vp, idx0.copy(), a0.copy(), op, origin=(1, 0, 0), domain=(4, 5, 4)
    )
    st_n(vn, idx0.copy(), a0.copy(), on, origin=(1, 0, 0), domain=(4, 5, 4))
    np.testing.assert_array_equal(op, on)
    np.testing.assert_array_equal(vp, vn)

"""Feature-surface tests: absolute K, variable-K clipping, GlobalTable,
exec_info, FrozenStencil, lazy_stencil, run(), dtype placeholders, vector
assignment (reference coverage: test_code_generation.py feature tests)."""

import numpy as np
import pytest

from gt4py_tpu import storage
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import (
    FORWARD,
    PARALLEL,
    computation,
    interval,
)

# kernel numerics for every stencil class, not only the default rule's
pytestmark = pytest.mark.usefixtures("all_kernel_classes")

Field3D = gtscript.Field[np.float64]

BACKENDS = ["numpy", "jax"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_absolute_k_literal(backend):
    """in_field.at(K=2) reads plane 2 everywhere
    (reference: test_code_generation.py:1240-1258; note the reference's
    numpy backend raises NotImplementedError -- ours supports it)."""

    @gtscript.stencil(backend=backend)
    def st(in_field: Field3D, out_field: Field3D):
        with computation(PARALLEL), interval(...):
            out_field = in_field.at(K=2)

    a = np.ones((5, 5, 5))
    a[:, :, 2] = 42.42
    out = np.zeros((5, 5, 5))
    st(a, out, origin=(0, 0, 0))
    assert (out == 42.42).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_absolute_k_scalar_and_field(backend):
    @gtscript.stencil(backend=backend)
    def by_param(in_field: Field3D, out_field: Field3D, *, idx: int):
        with computation(PARALLEL), interval(...):
            out_field = in_field.at(K=idx)

    a = np.ones((4, 4, 6))
    a[:, :, 3] = 7.5
    out = np.zeros_like(a)
    by_param(a, out, idx=3, origin=(0, 0, 0))
    assert (out == 7.5).all()

    @gtscript.stencil(backend=backend)
    def by_field(
        in_field: Field3D,
        index_field: gtscript.Field[gtscript.IJ, np.int64],
        out_field: Field3D,
    ):
        with computation(PARALLEL), interval(...):
            out_field = in_field.at(K=index_field)

    idx = np.ones((4, 4), dtype=np.int64)
    a2 = np.ones((4, 4, 6))
    a2[:, :, 1] = 42.0
    out2 = np.zeros_like(a2)
    by_field(a2, idx, out2, origin=(0, 0, 0))
    assert (out2 == 42.0).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_variable_k_clipping(backend):
    """Variable K offsets clip to the field bounds
    (reference: cartesian/utils/field.py:56-66)."""

    @gtscript.stencil(backend=backend)
    def st(inp: Field3D, off: gtscript.Field[np.int64], out: Field3D):
        with computation(PARALLEL), interval(...):
            out = inp[0, 0, off]

    nk = 5
    a = np.arange(nk, dtype=np.float64).reshape(1, 1, nk) * np.ones((3, 3, nk))
    off = np.full((3, 3, nk), 100, dtype=np.int64)  # far out of range -> clip
    out = np.zeros_like(a)
    st(a, off, out, origin=(0, 0, 0))
    assert (out == nk - 1).all()
    off[:] = -100
    st(a, off, out, origin=(0, 0, 0))
    assert (out == 0).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_global_table(backend):
    """GlobalTable: lookup table with data dimensions only
    (reference: gtscript.GlobalTable, gtscript.py:657-749)."""

    @gtscript.stencil(backend=backend)
    def st(table: gtscript.GlobalTable[(np.float64, (4,))], out: Field3D):
        with computation(PARALLEL), interval(...):
            out = table[2]

    table = np.array([1.0, 2.0, 3.0, 4.0])
    out = np.zeros((3, 3, 3))
    st(table, out, origin=(0, 0, 0), domain=(3, 3, 3))
    assert (out == 3.0).all()


@pytest.mark.parametrize("backend", ["numpy", "jax", "pallas"])
def test_field_valued_interval_bounds(backend):
    """Per-column K interval bounds from IJ int fields (net-new vs the
    reference: desugared at parse time to the K hull + a pointwise
    ``start <= K < end`` mask, so every backend executes them through
    the ordinary mask machinery)."""
    IJ = gtscript.Field[gtscript.IJ, np.int64]

    @gtscript.stencil(backend=backend)
    def st(a: Field3D, kstart: IJ, kend: IJ, out: Field3D):
        with computation(PARALLEL), interval(kstart, kend):
            out = a * 2.0
        with computation(FORWARD), interval(kstart + 1, None):
            out = out[0, 0, -1] + 1.0

    ni, nj, nk = 5, 6, 8
    rng = np.random.default_rng(0)
    a = rng.random((ni, nj, nk + 1))
    kstart = rng.integers(0, 4, (ni, nj)).astype(np.int64)
    kend = (kstart + rng.integers(1, 4, (ni, nj))).astype(np.int64)
    out_full = np.zeros((ni, nj, nk + 1))
    # K origin 1: the desugared scan runs over the full hull, so the
    # [0, 0, -1] read needs a K halo plane below the domain
    st(a, kstart, kend, out_full, origin=(0, 0, 1), domain=(ni, nj, nk))
    out = out_full[:, :, 1:]
    ai = a[:, :, 1:]

    expect = np.zeros((ni, nj, nk))
    for i in range(ni):
        for j in range(nj):
            for k in range(kstart[i, j], min(kend[i, j], nk)):
                expect[i, j, k] = ai[i, j, k] * 2.0
            for k in range(kstart[i, j] + 1, nk):
                expect[i, j, k] = expect[i, j, k - 1] + 1.0
    np.testing.assert_array_equal(out, expect)


def test_field_valued_interval_bound_errors():
    from gt4py_tpu.cartesian.frontend.parser import GTScriptSyntaxError

    IJK = gtscript.Field[np.int64]
    with pytest.raises(GTScriptSyntaxError, match="K-less"):

        @gtscript.stencil(backend="numpy")
        def bad_k(a: Field3D, b: IJK, out: Field3D):
            with computation(PARALLEL), interval(b, None):
                out = a

    FIJ = gtscript.Field[gtscript.IJ, np.float64]
    with pytest.raises(GTScriptSyntaxError, match="integer dtype"):

        @gtscript.stencil(backend="numpy")
        def bad_f(a: Field3D, b: FIJ, out: Field3D):
            with computation(PARALLEL), interval(b, None):
                out = a


@pytest.mark.parametrize("backend", ["numpy", "jax", "pallas"])
def test_dynamic_data_index(backend):
    """Per-point (field-valued) data-dimension indices gather along the
    data axis (reference: gtc/common.py:390-398 -- data_index is any int
    expression, not just a literal)."""
    IField = gtscript.Field[np.int64]

    @gtscript.stencil(backend=backend)
    def lookup(
        table: gtscript.GlobalTable[(np.float64, (4,))], idx: IField, out: Field3D
    ):
        with computation(PARALLEL), interval(...):
            out = table[idx]

    table = np.array([1.0, 2.0, 3.0, 4.0])
    rng = np.random.default_rng(11)
    idx = rng.integers(0, 4, (3, 4, 5)).astype(np.int64)
    out = np.zeros((3, 4, 5))
    lookup(table, idx, out, origin=(0, 0, 0), domain=(3, 4, 5))
    np.testing.assert_array_equal(out, table[idx])

    @gtscript.stencil(backend=backend)
    def pick(vec: gtscript.Field[(np.float64, (3,))], idx: IField, out: Field3D):
        with computation(FORWARD), interval(...):
            out = vec[0, 0, 0][idx % 3]

    vec = rng.random((3, 4, 5, 3))
    out2 = np.zeros((3, 4, 5))
    pick(vec, idx, out2, origin=(0, 0, 0), domain=(3, 4, 5))
    expect = np.take_along_axis(vec, (idx % 3)[..., None], axis=3)[..., 0]
    np.testing.assert_allclose(out2, expect, rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["numpy", "jax", "pallas"])
def test_dynamic_data_index_write(backend):
    """Per-point data-dimension WRITES: one-hot read-modify-write over
    the data axes (dynamic indices wrap modulo the dimension size,
    mirroring the read path); composes with if-masks."""
    IF = gtscript.Field[np.int64]

    @gtscript.stencil(backend=backend)
    def st(vec: gtscript.Field[(np.float64, (3,))], idx: IF, a: Field3D):
        with computation(PARALLEL), interval(...):
            vec[0, 0, 0][idx % 3] = a * 2.0
            if a > 0.5:
                vec[0, 0, 0][(idx + 1) % 3] = -1.0

    rng = np.random.default_rng(0)
    shape = (5, 6, 4)
    vec0 = rng.random(shape + (3,))
    idx0 = rng.integers(-5, 6, shape).astype(np.int64)
    a0 = rng.random(shape)
    vec = vec0.copy()
    st(vec, idx0.copy(), a0.copy(), origin=(0, 0, 0), domain=shape)

    expect = vec0.copy()
    ii, jj, kk = np.indices(shape)
    expect[ii, jj, kk, idx0 % 3] = a0 * 2.0
    m = a0 > 0.5
    expect[ii[m], jj[m], kk[m], (idx0[m] + 1) % 3] = -1.0
    np.testing.assert_array_equal(vec, expect)


@pytest.mark.parametrize("backend", BACKENDS)
def test_vector_assignment(backend):
    """Whole-vector assignment between data-dims fields (reference:
    frontend UnrollVectorAssignments, defir_to_gtir.py:123)."""

    @gtscript.stencil(backend=backend)
    def st(
        a: gtscript.Field[(np.float64, (3,))],
        b: gtscript.Field[(np.float64, (3,))],
    ):
        with computation(PARALLEL), interval(...):
            b = a

    av = np.random.default_rng(0).random((4, 4, 2, 3))
    bv = np.zeros_like(av)
    st(av, bv, origin=(0, 0, 0))
    np.testing.assert_array_equal(av, bv)


def test_exec_info_and_build_info():
    build_info = {}

    @gtscript.stencil(backend="numpy", build_info=build_info)
    def st(a: Field3D, b: Field3D):
        with computation(PARALLEL), interval(...):
            b = a

    assert build_info["parse_time"] > 0
    assert "build_time" in build_info

    exec_info = {}
    a, b = np.ones((3, 3, 3)), np.zeros((3, 3, 3))
    st(a, b, origin=(0, 0, 0), exec_info=exec_info)
    assert exec_info["call_run_end_time"] >= exec_info["call_run_start_time"]
    assert exec_info["run_end_time"] >= exec_info["run_start_time"]

    # '__aggregate_data' magic key: cumulative per-stencil stats
    agg_info = {"__aggregate_data": True}
    st(a, b, origin=(0, 0, 0), exec_info=agg_info)
    st(a, b, origin=(0, 0, 0), exec_info=agg_info)
    stats = agg_info["st"]
    assert stats["ncalls"] == 2
    assert stats["total_call_time"] >= stats["call_time"] > 0
    assert stats["total_run_time"] >= stats["run_time"] > 0


def test_lowered_formats():
    """stencil.lowered(): program text without executing (reference:
    program formatters)."""

    @gtscript.stencil(backend="jax")
    def st(a: Field3D, b: Field3D, *, w: np.float64):
        with computation(PARALLEL), interval(...):
            b = a[1, 0, 0] + w * a

    assert "computation(PARALLEL)" in st.lowered(format="ir")
    assert "f64" in st.lowered(format="jaxpr")
    assert "stablehlo" in st.lowered(format="hlo")

    @gtscript.stencil(backend="numpy")
    def nb(a: Field3D, b: Field3D):
        with computation(PARALLEL), interval(...):
            b = a

    assert "stencil" in nb.lowered(format="ir")
    import pytest as _pytest

    with _pytest.raises(TypeError, match="no lowered form"):
        nb.lowered(format="hlo")
    with _pytest.raises(ValueError, match="unknown format"):
        st.lowered(format="ptx")


def test_frozen_stencil_and_run():
    @gtscript.stencil(backend="numpy")
    def st(a: Field3D, b: Field3D, *, f: float):
        with computation(PARALLEL), interval(...):
            b = a * f

    a, b = np.ones((4, 4, 4)), np.zeros((4, 4, 4))

    frozen = st.freeze(origin={"_all_": (0, 0, 0)}, domain=(4, 4, 4))
    frozen(a=a, b=b, f=2.0)
    assert (b == 2.0).all()

    b[:] = 0
    st.run(a=a, b=b, f=3.0, _domain_=(4, 4, 4), _origin_={"_all_": (0, 0, 0)})
    assert (b == 3.0).all()


def test_lazy_stencil():
    from gt4py_tpu.cartesian.gtscript import lazy_stencil

    @lazy_stencil(backend="numpy")
    def st(a: Field3D, b: Field3D):
        with computation(PARALLEL), interval(...):
            b = a + 1.0

    # syntax checked but not built yet
    assert st.builder is not None
    a, b = np.ones((3, 3, 3)), np.zeros((3, 3, 3))
    st(a, b, origin=(0, 0, 0))
    assert (b == 2.0).all()
    assert "a" in st.field_info


def test_dtype_placeholders():
    """dtypes= mapping resolves annotation placeholders
    (reference: gtscript.stencil dtypes argument)."""

    def defn(a: gtscript.Field["dtype"], b: gtscript.Field["dtype"]):  # noqa: F821
        with computation(PARALLEL), interval(...):
            b = a * 2.0

    st = gtscript.stencil(backend="numpy", definition=defn, dtypes={"dtype": np.float32})
    a = np.ones((3, 3, 3), dtype=np.float32)
    b = np.zeros((3, 3, 3), dtype=np.float32)
    st(a, b, origin=(0, 0, 0))
    assert (b == 2.0).all()


def test_stencil_object_str_and_cache():
    @gtscript.stencil(backend="numpy")
    def st(a: Field3D, b: Field3D):
        with computation(FORWARD), interval(...):
            b = a

    text = str(st)
    assert "field a" in text and "field b" in text

    # identical definition+options returns the cached object
    @gtscript.stencil(backend="numpy")
    def st2(a: Field3D, b: Field3D):
        with computation(FORWARD), interval(...):
            b = a

    assert st2.stencil_id != "" and isinstance(st2.stencil_id, str)


@pytest.mark.parametrize("backend", BACKENDS)
def test_runtime_interval_bounds(backend):
    """interval(kstart, kend) with scalar parameters
    (reference: RuntimeAxisBound, frontend/nodes.py)."""

    @gtscript.stencil(backend=backend)
    def st(inp: Field3D, out: Field3D, *, kstart: int, kend: int):
        with computation(PARALLEL), interval(kstart, kend):
            out = inp + 1.0
        with computation(FORWARD), interval(kstart + 1, None):
            out = out + 0.5

    nk = 8
    a = np.zeros((3, 3, nk))
    out = np.zeros_like(a)
    st(a, out, kstart=2, kend=5, origin=(0, 0, 0))
    expected = np.zeros(nk)
    expected[2:5] += 1.0
    expected[3:] += 0.5
    np.testing.assert_array_equal(out[0, 0], expected)

    # different bound values re-specialize correctly
    out[:] = 0.0
    st(a, out, kstart=0, kend=2, origin=(0, 0, 0))
    expected = np.zeros(nk)
    expected[0:2] += 1.0
    expected[1:] += 0.5
    np.testing.assert_array_equal(out[0, 0], expected)


@pytest.mark.parametrize("backend", BACKENDS)
def test_axis_index_interval_bounds(backend):
    """interval(K[2], -1) axis-index bounds
    (reference: test_gtscript_frontend.py:730-847)."""
    from gt4py_tpu.cartesian.gtscript import K

    @gtscript.stencil(backend=backend)
    def st(inp: Field3D, out: Field3D):
        with computation(PARALLEL), interval(K[2], -1):
            out = inp + 1.0
        with computation(PARALLEL), interval(K[-1], None):
            out = inp + 5.0

    nk = 6
    a = np.zeros((3, 3, nk))
    out = np.zeros_like(a)
    st(a, out, origin=(0, 0, 0))
    expected = np.zeros(nk)
    expected[2 : nk - 1] = 1.0
    expected[nk - 1] = 5.0
    np.testing.assert_array_equal(out[0, 0], expected)


def test_axis_index_external_bound():
    """An external bound to gtscript.K[n] works as an interval bound."""
    from gt4py_tpu.cartesian.gtscript import K

    KSTART = K[3]

    @gtscript.stencil(backend="numpy")
    def st(inp: Field3D, out: Field3D):
        with computation(PARALLEL), interval(KSTART, None):
            out = inp + 2.0

    nk = 5
    a = np.zeros((2, 2, nk))
    out = np.zeros_like(a)
    st(a, out, origin=(0, 0, 0))
    np.testing.assert_array_equal(out[0, 0, 3:], 2.0)
    np.testing.assert_array_equal(out[0, 0, :3], 0.0)


def test_gt_dims_axis_reordering():
    """Duck arrays carrying __gt_dims__ in a non-canonical order are
    transposed (as views) to the declared (I, J, K) order at call time,
    with __gt_origin__ permuted along (reference: the __gt_dims__
    storage protocol)."""

    class Duck(np.ndarray):
        pass

    @gtscript.stencil(backend="numpy")
    def st(a: Field3D, out: Field3D):
        with computation(PARALLEL), interval(...):
            out = a[1, 0, 0] + a[-1, 0, 0]

    rng = np.random.default_rng(0)
    base = rng.random((6, 5, 4))  # logical (I, J, K)
    kji = np.ascontiguousarray(np.transpose(base, (2, 1, 0))).view(Duck)
    kji.__gt_dims__ = ("K", "J", "I")
    kji.__gt_origin__ = (0, 0, 1)  # per ITS axis order: K, J, I
    out = np.zeros((6, 5, 4))
    st(kji, out, origin=(1, 0, 0), domain=(4, 5, 4))
    expect = base[2:, :, :] + base[:-2, :, :]
    np.testing.assert_array_equal(out[1:5], expect)

    # writes go through the transposed view into the original layout
    out_kji = np.ascontiguousarray(np.zeros((4, 5, 6))).view(Duck)
    out_kji.__gt_dims__ = ("K", "J", "I")
    st(kji, out_kji, origin=(1, 0, 0), domain=(4, 5, 4))
    np.testing.assert_array_equal(np.transpose(out_kji, (2, 1, 0))[1:5], expect)

    # mismatched axis sets are rejected
    bad = base.view(Duck)
    bad.__gt_dims__ = ("I", "J", "X")
    from gt4py_tpu.cartesian.stencil_object import ArgumentError

    with pytest.raises(ArgumentError, match="__gt_dims__"):
        st(bad, out, origin=(1, 0, 0), domain=(4, 5, 4))


@pytest.mark.parametrize("backend", ["numpy", "jax", "pallas"])
def test_dynamic_data_index_out_of_range_wraps(backend):
    """Out-of-range DYNAMIC indices wrap modulo the dimension size on
    every backend (review fix: numpy raised, jax NaN-filled, pallas
    wrapped -- three-way divergence)."""
    IF = gtscript.Field[np.int64]

    @gtscript.stencil(backend=backend)
    def st(vec: gtscript.Field[(np.float64, (3,))], idx: IF, out: Field3D):
        with computation(PARALLEL), interval(...):
            out = vec[0, 0, 0][idx]

    rng = np.random.default_rng(2)
    shape = (3, 4, 2)
    vec = rng.random(shape + (3,))
    idx = np.array([[-7, 5], [4, -1], [0, 9], [2, -4]] * 3).reshape(shape)
    out = np.zeros(shape)
    st(vec.copy(), idx.astype(np.int64), out, origin=(0, 0, 0), domain=shape)
    expect = np.take_along_axis(vec, (idx % 3)[..., None], axis=3)[..., 0]
    np.testing.assert_array_equal(out, expect)


def test_static_data_index_out_of_range_rejected():
    from gt4py_tpu.cartesian.validation import GTScriptValidationError

    with pytest.raises(GTScriptValidationError, match="out of range"):

        @gtscript.stencil(backend="numpy")
        def bad(vec: gtscript.Field[(np.float64, (3,))], out: Field3D):
            with computation(PARALLEL), interval(...):
                out = vec[0, 0, 0][5]


# ---- `@` matrix-vector products on data-dims fields ---- #
# Reference: gtscript_frontend.py:1506 (MatMult), defir_to_gtir.py:265-273
# (unrolled multiply-add chain), `.T` transposed reads.


@pytest.mark.parametrize("backend", ["numpy", "debug", "jax", "pallas"])
def test_matmul_globaltable(backend):
    """GlobalTable[(f64,(3,3))] @ vec on every backend (VERDICT r4 #8)."""

    @gtscript.stencil(backend=backend, name=f"mm_gt_{backend}")
    def st(
        table: gtscript.GlobalTable[(np.float64, (3, 3))],
        vin: gtscript.Field[(np.float64, (3,))],
        vout: gtscript.Field[(np.float64, (3,))],
    ):
        with computation(PARALLEL), interval(...):
            vout = table @ vin

    shape = (5, 4, 3)
    rng = np.random.default_rng(1)
    t = rng.uniform(-3, 3, (3, 3))
    vi = rng.uniform(-3, 3, shape + (3,))
    vo = np.zeros_like(vi)
    st(t.copy(), vi.copy(), vo, origin=(0, 0, 0))
    np.testing.assert_allclose(
        vo, np.einsum("lm,ijkm->ijkl", t, vi), rtol=1e-12
    )


@pytest.mark.parametrize("backend", ["numpy", "jax", "pallas"])
def test_matmul_self_aliasing_is_simultaneous(backend):
    """`v = m @ v` must read the pre-statement v for every component
    (parallel-assignment semantics; the unroll stages via temps)."""

    @gtscript.stencil(backend=backend, name=f"mm_alias_{backend}")
    def st(
        m: gtscript.Field[(np.float64, (3, 3))],
        v: gtscript.Field[(np.float64, (3,))],
    ):
        with computation(PARALLEL), interval(...):
            v = m @ v

    shape = (4, 4, 2)
    rng = np.random.default_rng(2)
    mv = rng.uniform(-2, 2, shape + (3, 3))
    vv = rng.uniform(-2, 2, shape + (3,))
    expect = np.einsum("ijklm,ijkm->ijkl", mv, vv)
    got = vv.copy()
    st(mv.copy(), got, origin=(0, 0, 0))
    np.testing.assert_allclose(got, expect, rtol=1e-12)


def test_matmul_scaled_product_expression():
    """`@` composes with elementwise vector arithmetic on the RHS."""

    @gtscript.stencil(backend="numpy")
    def st(
        m: gtscript.Field[(np.float64, (2, 2))],
        v: gtscript.Field[(np.float64, (2,))],
        o: gtscript.Field[(np.float64, (2,))],
    ):
        with computation(PARALLEL), interval(...):
            o = m @ v + 2.0 * v

    shape = (3, 3, 2)
    rng = np.random.default_rng(3)
    mv = rng.uniform(-2, 2, shape + (2, 2))
    vv = rng.uniform(-2, 2, shape + (2,))
    ov = np.zeros_like(vv)
    st(mv.copy(), vv.copy(), ov, origin=(0, 0, 0))
    np.testing.assert_allclose(
        ov, np.einsum("ijklm,ijkm->ijkl", mv, vv) + 2.0 * vv, rtol=1e-12
    )


def test_matmul_errors():
    def dim_mismatch(
        m: gtscript.Field[(np.float64, (2, 2))],
        v: gtscript.Field[(np.float64, (3,))],
        o: gtscript.Field[(np.float64, (2,))],
    ):
        with computation(PARALLEL), interval(...):
            o = m @ v

    def scalar_operands(a: gtscript.Field[np.float64], b: gtscript.Field[np.float64]):
        with computation(PARALLEL), interval(...):
            b = a @ a

    def temp_target(
        m: gtscript.Field[(np.float64, (2, 2))],
        v: gtscript.Field[(np.float64, (2,))],
        o: gtscript.Field[(np.float64, (2,))],
    ):
        with computation(PARALLEL), interval(...):
            tmp = m @ v
            o = tmp + v

    for bad in (dim_mismatch, scalar_operands, temp_target):
        with pytest.raises(Exception, match="@|vector|matrix|data dims"):
            gtscript.stencil(backend="numpy", name=f"bad_{bad.__name__}")(bad)

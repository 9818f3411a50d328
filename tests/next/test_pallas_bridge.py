"""next field operators compiled to fused cartesian Pallas kernels.

``with_backend("pallas")`` lowers eligible operators through
next/pallas_bridge.py; everything else falls back to the jit-staged
embedded path transparently.  Reference analog: the compiled program
processors (gtfn/dace runners, src/gt4py/next/program_processors/).

Every test compares against the numpy_oracle embedded executor --
values AND result domains.
"""

import numpy as np
import pytest

import gt4py_tpu.next as gtx
from gt4py_tpu.next import (
    Dims,
    Field,
    astype,
    backends,
    broadcast,
    exp,
    log,
    maximum,
    sqrt,
    where,
)
from gt4py_tpu.next.builtins import neighbor_sum

# kernel numerics for every stencil class, not only the default rule's
pytestmark = pytest.mark.usefixtures("all_kernel_classes")

I = gtx.Dimension("I")
J = gtx.Dimension("J")
K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)
Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
Joff = gtx.FieldOffset("Joff", source=J, target=(J,))
Koff = gtx.FieldOffset("Koff", source=K, target=(K,))

F64 = Field[Dims[I, J, K], gtx.float64]
F64_IJ = Field[Dims[I, J], gtx.float64]
F32 = Field[Dims[I, J, K], gtx.float32]


def _ranges(f):
    return [(r.start, r.stop) for r in f.domain.ranges]


def _check(op, *args, rtol=1e-12, expect_plan=True):
    ref = op.with_backend(backends.numpy_oracle)(*args)
    from gt4py_tpu.cartesian.backend import pallas_backend

    before = len(pallas_backend.FALLBACK_EVENTS)
    got = op.with_backend("pallas")(*args)
    assert not pallas_backend.FALLBACK_EVENTS[before:]
    if expect_plan:
        plans = op.with_backend("pallas").__dict__  # fresh copy: no state
    assert _ranges(ref) == _ranges(got)
    assert got.dims == ref.dims
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=rtol, atol=0)
    return got


def _bridge_plan_of(op, *args):
    """The BridgePlan the pallas backend builds for these argument types
    (None = ineligible -> embedded fallback)."""
    from gt4py_tpu.next import pallas_bridge
    from gt4py_tpu.next.ffront import _value_type

    arg_types = tuple(_value_type(a) for a in args)
    typed, _ = op._typed_for(arg_types)
    try:
        return pallas_bridge.lower_field_operator(typed)
    except pallas_bridge.Ineligible:
        return None


def _rand(shape, seed=0, dtype=np.float64):
    return np.random.default_rng(seed).random(shape).astype(dtype)


def test_hdiff_matches_oracle_and_domain():
    @gtx.field_operator
    def hdiff(inp: F64, coeff: F64) -> F64:
        lap = 4.0 * inp - (
            inp(Ioff[1]) + inp(Ioff[-1]) + inp(Joff[1]) + inp(Joff[-1])
        )
        flx = lap(Ioff[1]) - lap
        flx = where(flx * (inp(Ioff[1]) - inp) > 0.0, 0.0, flx)
        fly = lap(Joff[1]) - lap
        fly = where(fly * (inp(Joff[1]) - inp) > 0.0, 0.0, fly)
        return inp - coeff * (flx - flx(Ioff[-1]) + fly - fly(Joff[-1]))

    inp = gtx.as_field((I, J, K), _rand((20, 18, 5), 1))
    coeff = gtx.as_field((I, J, K), 0.025 * _rand((20, 18, 5), 2))
    assert _bridge_plan_of(hdiff, inp, coeff) is not None
    _check(hdiff, inp, coeff)


def test_asymmetric_shift_domain():
    @gtx.field_operator
    def sh(a: F64) -> F64:
        return a(Ioff[1]) + a(Koff[-1]) + a

    a = gtx.as_field((I, J, K), _rand((9, 7, 6), 3))
    got = _check(sh, a)
    # reads at I+1 and K-1: domain shrinks on the upper I side and the
    # lower K side only
    assert _ranges(got) == [(0, 8), (0, 7), (1, 6)]


def test_2d_fields():
    @gtx.field_operator
    def grad(a: F64_IJ) -> F64_IJ:
        return a(Ioff[1]) - 2.0 * a + a(Ioff[-1])

    a = gtx.as_field((I, J), _rand((12, 10), 4))
    _check(grad, a)


def test_scalar_params_and_weak_literals_f32():
    @gtx.field_operator
    def saxpy(a: F32, b: F32, w: gtx.float32) -> F32:
        return w * a + b * 0.5 + 1.0

    a = gtx.as_field((I, J, K), _rand((8, 8, 4), 5, np.float32))
    b = gtx.as_field((I, J, K), _rand((8, 8, 4), 6, np.float32))
    got = _check(saxpy, a, b, np.float32(1.25), rtol=1e-6)
    assert got.dtype == np.float32  # weak literals must not upcast


def test_math_builtins_chain():
    from gt4py_tpu.next.builtins import log2

    @gtx.field_operator
    def chain(a: F64) -> F64:
        return sqrt(exp(log(a + 1.5))) + maximum(a, a(Ioff[1])) + log2(a + 2.0)

    a = gtx.as_field((I, J, K), _rand((9, 9, 3), 7))
    _check(chain, a)


def test_astype_and_compare():
    @gtx.field_operator
    def conv(a: F64) -> F32:
        return astype(a * 2.0, gtx.float32)

    a = gtx.as_field((I, J, K), _rand((6, 6, 3), 8))
    got = _check(conv, a, rtol=1e-6)
    assert got.dtype == np.float32


def test_dims_order_transposed():
    FT = Field[Dims[K, J, I], gtx.float64]

    @gtx.field_operator
    def lap(a: FT) -> FT:
        return a(Ioff[1]) + a(Ioff[-1]) + a(Joff[1]) + a(Joff[-1]) - 4.0 * a

    a = gtx.as_field((K, J, I), _rand((4, 10, 11), 9))
    _check(lap, a)


def test_chained_shift():
    @gtx.field_operator
    def diag(a: F64) -> F64:
        return a(Ioff[1])(Joff[1]) - a

    a = gtx.as_field((I, J, K), _rand((7, 7, 3), 10))
    _check(diag, a)


def test_unstructured_falls_back():
    from gt4py_tpu.next.testing import Edge, Vertex, simple_mesh_case

    case, mesh = simple_mesh_case(allocator="jax")
    V2E = mesh.v2e

    @gtx.field_operator
    def gather(e: Field[Dims[Edge], gtx.float64]) -> Field[Dims[Vertex], gtx.float64]:
        return neighbor_sum(e(V2E), axis=V2E)

    e = gtx.as_field((Edge,), _rand((mesh.n_edges,), 11))
    assert _bridge_plan_of(gather, e) is None  # ineligible
    ref = gather.with_backend(backends.numpy_oracle)(e)
    got = gather.with_backend("pallas")(e)  # transparent fallback
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=1e-13)


def test_broadcast_scalar():
    @gtx.field_operator
    def bc(a: F64) -> F64:
        return a + broadcast(2.5, (I, J, K))

    a = gtx.as_field((I, J, K), _rand((6, 5, 4), 12))
    _check(bc, a)


def test_kernel_path_actually_runs():
    """The bridge must execute through the cartesian pallas backend (a
    recorded tile plan), not silently through the embedded path."""
    from gt4py_tpu.cartesian.backend import pallas_backend

    @gtx.field_operator
    def op_unique_name_xyz(a: F64) -> F64:
        return a(Ioff[1]) - a

    a = gtx.as_field((I, J, K), _rand((16, 16, 4), 13))
    op_unique_name_xyz.with_backend("pallas")(a)
    assert "next_op_unique_name_xyz" in pallas_backend.LAST_PLAN


def test_out_and_domain_restriction():
    @gtx.field_operator
    def lap(a: F64) -> F64:
        return a(Ioff[1]) + a(Ioff[-1]) + a(Joff[1]) + a(Joff[-1]) - 4.0 * a

    a = gtx.as_field((I, J, K), _rand((16, 14, 4), 14))
    dom = gtx.common.Domain(
        (I, J, K),
        (gtx.common.UnitRange(3, 9), gtx.common.UnitRange(2, 10),
         gtx.common.UnitRange(0, 4)),
    )
    out_p = gtx.as_field((I, J, K), np.zeros((16, 14, 4)))
    out_r = gtx.as_field((I, J, K), np.zeros((16, 14, 4)))
    lap.with_backend("pallas")(a, out=out_p, domain=dom)
    lap.with_backend(backends.numpy_oracle)(a, out=out_r, domain=dom)
    np.testing.assert_allclose(out_p.asnumpy(), out_r.asnumpy(), rtol=1e-12)
    # untouched outside the domain
    assert out_p.asnumpy()[0, 0, 0] == 0.0


def test_program_routes_operators_through_bridge():
    from gt4py_tpu.cartesian.backend import pallas_backend
    from gt4py_tpu.next import program

    @gtx.field_operator
    def op_prog_probe(a: F64) -> F64:
        return a(Ioff[1]) + a(Ioff[-1]) - 2.0 * a

    @program
    def prog(a: F64, o: F64):
        op_prog_probe(a, out=o[1:-1])

    a = gtx.as_field((I, J, K), _rand((14, 8, 3), 15))
    o_p = gtx.as_field((I, J, K), np.zeros((14, 8, 3)))
    o_r = gtx.as_field((I, J, K), np.zeros((14, 8, 3)))
    prog.with_backend("pallas")(a, o_p)
    prog.with_backend(backends.numpy_oracle)(a, o_r)
    np.testing.assert_allclose(o_p.asnumpy(), o_r.asnumpy(), rtol=1e-12)
    assert "next_op_prog_probe" in pallas_backend.LAST_PLAN


# --------------------------------------------------------------------------- #
# Scan operators -> serial-K cartesian kernels (pallas_bridge.lower_scan_operator)
# --------------------------------------------------------------------------- #


def _check_scan(op, *args, rtol=1e-13):
    """Compare the pallas-bridged scan against the numpy oracle, values and
    domains, asserting the kernel path ran (no cartesian fallback)."""
    from gt4py_tpu.cartesian.backend import pallas_backend

    ref = op.with_backend(backends.numpy_oracle)(*args)
    before = len(pallas_backend.FALLBACK_EVENTS)
    bound = op.with_backend("pallas")
    got = bound(*args)
    assert not pallas_backend.FALLBACK_EVENTS[before:]
    assert bound.__dict__.get("_scan_bridge_plans"), "scan did not lower"
    assert all(
        p is not None for p in bound.__dict__["_scan_bridge_plans"].values()
    ), "scan plan ineligible"
    for r, g in zip(
        ref if isinstance(ref, tuple) else (ref,),
        got if isinstance(got, tuple) else (got,),
    ):
        assert _ranges(r) == _ranges(g)
        assert r.dims == g.dims
        np.testing.assert_allclose(g.asnumpy(), r.asnumpy(), rtol=rtol, atol=0)
    return got


def test_scan_cumsum_forward():
    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def cumsum(carry: gtx.float64, x: gtx.float64) -> gtx.float64:
        return carry + x

    x = gtx.as_field((I, J, K), _rand((9, 10, 7), 20))
    _check_scan(cumsum, x)


def test_scan_backward_with_scalar_param():
    @gtx.scan_operator(axis=K, forward=False, init=1.0)
    def damp(carry: gtx.float64, x: gtx.float64, w: gtx.float64) -> gtx.float64:
        return carry * w + x

    x = gtx.as_field((I, J, K), _rand((8, 6, 9), 21))
    _check_scan(damp, x, 0.75)


def test_scan_tuple_carry():
    @gtx.scan_operator(axis=K, forward=True, init=(0.0, 1.0))
    def ms(carry: tuple[gtx.float64, gtx.float64], x: gtx.float64):
        s = carry[0] + x
        p = carry[1] * (x + 0.5)
        return (s, p)

    x = gtx.as_field((I, J, K), _rand((7, 7, 6), 22))
    _check_scan(ms, x)


def test_scan_where_and_builtins_in_body():
    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def relu_sum(carry: gtx.float64, x: gtx.float64) -> gtx.float64:
        return carry + where(x > 0.5, sqrt(x), maximum(x, 0.25))

    x = gtx.as_field((I, J, K), _rand((6, 8, 5), 23))
    _check_scan(relu_sum, x)


def test_scan_broadcast_arg_without_scan_axis():
    """A 2D IJ argument broadcasts along K (embedded _merge_domains)."""

    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def acc(carry: gtx.float64, x: gtx.float64, g: gtx.float64) -> gtx.float64:
        return carry + x * g

    x = gtx.as_field((I, J, K), _rand((9, 5, 6), 24))
    g = gtx.as_field((I, J), _rand((9, 5), 25))
    _check_scan(acc, x, g)


def test_scan_f32_weak_init():
    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def cs32(carry: gtx.float32, x: gtx.float32) -> gtx.float32:
        return carry + x

    x = gtx.as_field((I, J, K), _rand((8, 8, 10), 26, np.float32))
    got = _check_scan(cs32, x, rtol=1e-6)
    assert got.dtype == np.float32


def test_scan_out_and_program():
    from gt4py_tpu.cartesian.backend import pallas_backend
    from gt4py_tpu.next import program

    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def csum_prog(carry: gtx.float64, x: gtx.float64) -> gtx.float64:
        return carry + x

    @program
    def prog(x: F64, o: F64):
        csum_prog(x, out=o)

    x = gtx.as_field((I, J, K), _rand((10, 6, 5), 27))
    o_p = gtx.as_field((I, J, K), np.zeros((10, 6, 5)))
    o_r = gtx.as_field((I, J, K), np.zeros((10, 6, 5)))
    prog.with_backend("pallas")(x, o_p)
    prog.with_backend(backends.numpy_oracle)(x, o_r)
    np.testing.assert_allclose(o_p.asnumpy(), o_r.asnumpy(), rtol=1e-13)
    assert "next_scan_csum_prog" in pallas_backend.LAST_PLAN


def test_scan_tridiagonal_thomas():
    """Thomas algorithm as two scans (tuple-carry forward elimination +
    backward substitution) -- the canonical serial-K kernel; reference
    pattern: test_execution.py solve_nonhydro_stencil-style scans."""

    @gtx.scan_operator(axis=K, forward=True, init=(0.0, 0.0))
    def fwd(carry: tuple[gtx.float64, gtx.float64], a: gtx.float64,
            b: gtx.float64, c: gtx.float64, d: gtx.float64):
        denom = b - a * carry[0]
        cp = c / denom
        dp = (d - a * carry[1]) / denom
        return (cp, dp)

    @gtx.scan_operator(axis=K, forward=False, init=0.0)
    def bwd(carry: gtx.float64, cp: gtx.float64, dp: gtx.float64) -> gtx.float64:
        return dp - cp * carry

    rng = np.random.default_rng(28)
    shape = (6, 7, 12)
    a = gtx.as_field((I, J, K), rng.random(shape))
    b = gtx.as_field((I, J, K), rng.random(shape) + 4.0)  # diag dominant
    c = gtx.as_field((I, J, K), rng.random(shape))
    d = gtx.as_field((I, J, K), rng.random(shape))

    cp_r, dp_r = fwd.with_backend(backends.numpy_oracle)(a, b, c, d)
    x_r = bwd.with_backend(backends.numpy_oracle)(cp_r, dp_r)
    cp_g, dp_g = fwd.with_backend("pallas")(a, b, c, d)
    x_g = bwd.with_backend("pallas")(cp_g, dp_g)
    np.testing.assert_allclose(x_g.asnumpy(), x_r.asnumpy(), rtol=1e-12)

    # and the solution actually solves the system
    A, B, C, D, X = (v.asnumpy() for v in (a, b, c, d, x_g))
    res = B * X
    res[:, :, 1:] += A[:, :, 1:] * X[:, :, :-1]
    res[:, :, :-1] += C[:, :, :-1] * X[:, :, 1:]
    np.testing.assert_allclose(res, D, rtol=1e-10)


def test_scan_unstructured_falls_back():
    """Scans over non-vertical / unstructured dims keep the embedded path."""
    from gt4py_tpu.next.testing import Vertex, simple_mesh_case

    case, mesh = simple_mesh_case(allocator="jax")

    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def vsum(carry: gtx.float64, x: gtx.float64) -> gtx.float64:
        return carry + x

    x = gtx.as_field((Vertex, K), _rand((mesh.n_vertices, 4), 29))
    ref = vsum.with_backend(backends.numpy_oracle)(x)
    got = vsum.with_backend("pallas")(x)  # Vertex dim -> Ineligible -> embedded
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=1e-13)


# ------------------------- tuple-returning operators ------------------------ #


def test_tuple_return_fused_kernel():
    """Tuple members with identical read extents fuse into ONE kernel."""
    from gt4py_tpu.cartesian.backend import pallas_backend

    @gtx.field_operator
    def fluxes(a: F64):
        lap = a(Ioff[1]) + a(Ioff[-1]) + a(Joff[1]) + a(Joff[-1]) - 4.0 * a
        fx = lap * 0.5 + a
        fy = lap * 0.25 - a
        return (fx, fy)

    a = gtx.as_field((I, J, K), _rand((14, 12, 5), 30))
    rx, ry = fluxes.with_backend(backends.numpy_oracle)(a)
    before = len(pallas_backend.FALLBACK_EVENTS)
    gx, gy = fluxes.with_backend("pallas")(a)
    assert not pallas_backend.FALLBACK_EVENTS[before:]
    assert "next_fluxes" in pallas_backend.LAST_PLAN
    for r, g in ((rx, gx), (ry, gy)):
        assert _ranges(r) == _ranges(g)
        np.testing.assert_allclose(g.asnumpy(), r.asnumpy(), rtol=1e-12, atol=0)


def test_tuple_return_mixed_dtypes():
    @gtx.field_operator
    def two(a: F64):
        return (a * 2.0, astype(a, gtx.float32))

    a = gtx.as_field((I, J, K), _rand((8, 8, 4), 31))
    r0, r1 = two.with_backend(backends.numpy_oracle)(a)
    g0, g1 = two.with_backend("pallas")(a)
    assert g1.dtype == np.float32
    np.testing.assert_allclose(g0.asnumpy(), r0.asnumpy(), rtol=1e-12)
    np.testing.assert_allclose(g1.asnumpy(), r1.asnumpy(), rtol=1e-6)


def test_tuple_return_differing_extents_falls_back():
    """Members whose domains would differ keep the embedded path (each
    tuple member gets its OWN domain there)."""

    @gtx.field_operator
    def uneven(a: F64):
        return (a(Ioff[1]) - a, a(Joff[1]) - a)

    a = gtx.as_field((I, J, K), _rand((9, 9, 3), 32))
    assert _bridge_plan_of(uneven, a) is None
    r0, r1 = uneven.with_backend(backends.numpy_oracle)(a)
    g0, g1 = uneven.with_backend("pallas")(a)  # transparent fallback
    assert _ranges(r0) == _ranges(g0) and _ranges(r1) == _ranges(g1)
    np.testing.assert_allclose(g0.asnumpy(), r0.asnumpy(), rtol=1e-13)
    np.testing.assert_allclose(g1.asnumpy(), r1.asnumpy(), rtol=1e-13)


def test_tuple_return_asymmetric_nonzero_offsets_falls_back():
    """The r3-advisor shape: the same input read at asymmetric NONZERO
    offsets across members.  Zero-widened extent hulls coincide ((0,2)
    for both members) while the embedded per-member domains differ --
    the tuple gate must compare EXACT demand, not widened extents."""

    @gtx.field_operator
    def asym(a: F64):
        return (a(Ioff[1]) + a(Ioff[2]), a + a(Ioff[2]))

    a = gtx.as_field((I, J, K), _rand((10, 6, 3), 34))
    assert _bridge_plan_of(asym, a) is None
    r0, r1 = asym.with_backend(backends.numpy_oracle)(a)
    g0, g1 = asym.with_backend("pallas")(a)  # transparent fallback
    # member 0's domain starts one row EARLIER than member 1's
    assert _ranges(r0)[0] == (-1, 8) and _ranges(r1)[0] == (0, 8)
    assert _ranges(r0) == _ranges(g0) and _ranges(r1) == _ranges(g1)
    np.testing.assert_allclose(g0.asnumpy(), r0.asnumpy(), rtol=1e-13)
    np.testing.assert_allclose(g1.asnumpy(), r1.asnumpy(), rtol=1e-13)


def test_tuple_return_equal_nonzero_offsets_still_fuses():
    """Members reading the same input at the SAME nonzero extents keep
    the fused kernel (the exact gate must not over-reject)."""
    from gt4py_tpu.cartesian.backend import pallas_backend

    @gtx.field_operator
    def sym(a: F64):
        return (a(Ioff[1]) - a, a + a(Ioff[1]))

    a = gtx.as_field((I, J, K), _rand((10, 6, 3), 35))
    assert _bridge_plan_of(sym, a) is not None
    r0, r1 = sym.with_backend(backends.numpy_oracle)(a)
    g0, g1 = sym.with_backend("pallas")(a)
    assert _ranges(r0) == _ranges(g0) and _ranges(r1) == _ranges(g1)
    np.testing.assert_allclose(g0.asnumpy(), r0.asnumpy(), rtol=1e-13)
    np.testing.assert_allclose(g1.asnumpy(), r1.asnumpy(), rtol=1e-13)


def test_tuple_return_out_in_program():
    from gt4py_tpu.next import program

    @gtx.field_operator
    def pair(a: F64):
        m = a(Ioff[1]) + a(Ioff[-1]) - 2.0 * a
        return (m + a, m - a)

    @program
    def prog(a: F64, o1: F64, o2: F64):
        pair(a, out=(o1[1:-1], o2[1:-1]))

    a = gtx.as_field((I, J, K), _rand((12, 7, 4), 33))
    zeros = lambda: gtx.as_field((I, J, K), np.zeros((12, 7, 4)))
    o1p, o2p, o1r, o2r = zeros(), zeros(), zeros(), zeros()
    prog.with_backend("pallas")(a, o1p, o2p)
    prog.with_backend(backends.numpy_oracle)(a, o1r, o2r)
    np.testing.assert_allclose(o1p.asnumpy(), o1r.asnumpy(), rtol=1e-12)
    np.testing.assert_allclose(o2p.asnumpy(), o2r.asnumpy(), rtol=1e-12)


def test_gap_masked_field_with_restricted_k_offset():
    """(I, K) fields (no J) read at a K offset under out=+domain=: the
    backend consumes origins per PRESENT axis (compressed), so the K
    origin must not land in the absent-J slot (r4 program-fuzz seed 1:
    the full-3-tuple form built a zero-size K window)."""

    @gtx.field_operator
    def op(a: Field[Dims[I, K], gtx.float64]):
        return where(a > 0.25, a - (a(Koff[-2]) - 0.4), a * 0.5)

    a = gtx.as_field((I, K), _rand((10, 9), 40))
    o_r = gtx.as_field((I, K), np.full((10, 9), -3.0))
    o_p = gtx.as_field((I, K), np.full((10, 9), -3.0))
    dom = {I: (2, 7), K: (2, 7)}
    op.with_backend(backends.numpy_oracle)(a, out=o_r, domain=dom)
    op.with_backend("pallas")(a, out=o_p, domain=dom)
    np.testing.assert_allclose(o_p.asnumpy(), o_r.asnumpy(), rtol=1e-13)


def test_kwargs_calls_lower():
    """Keyword arguments canonicalize through the callee's signature at
    lowering time (reference: func_to_foast canonicalization) -- both on
    builtins and on inlined operator calls (r3 verdict: these silently
    dropped to the 3-5x jit path)."""

    @gtx.field_operator
    def helper(x: F64, w: gtx.float64) -> F64:
        return x * w + x(Ioff[1])

    @gtx.field_operator
    def op(a: F64, s: gtx.float64):
        t = where(a > 0.5, a * 2.0, a - 1.0)
        u = helper(w=s, x=t)
        return maximum(u, helper(t, w=0.25))

    a = gtx.as_field((I, J, K), _rand((9, 7, 4), 60))
    assert _bridge_plan_of(op, a, np.float64(0.3)) is not None
    _check(op, a, np.float64(0.3))


def test_whole_tuple_carry_return_lowers():
    """`return carry` on a tuple-carry scan expands to per-element
    subscripts instead of falling back."""

    @gtx.scan_operator(axis=K, forward=True, init=(2.0, 3.0))
    def ident(carry: tuple[gtx.float64, gtx.float64], x: gtx.float64):
        return carry

    a = gtx.as_field((I, J, K), _rand((6, 5, 7), 61))
    r0, r1 = ident.with_backend(backends.numpy_oracle)(a)
    bound = ident.with_backend("pallas")
    g0, g1 = bound(a)
    plans = bound.__dict__.get("_scan_bridge_plans", {})
    assert any(p is not None for p in plans.values())
    np.testing.assert_allclose(g0.asnumpy(), r0.asnumpy(), rtol=1e-13)
    np.testing.assert_allclose(g1.asnumpy(), r1.asnumpy(), rtol=1e-13)


# ------------------------- concat_where (K sections) ------------------------ #


def _check_cw(op, *args, expect_lower=True, rtol=1e-13):
    """Oracle-vs-pallas for concat_where operators: values, dims AND
    domains; `expect_lower` asserts zero bridge fallbacks."""
    from gt4py_tpu.next import pallas_bridge

    ref = op.with_backend(backends.numpy_oracle)(*args)
    cur = pallas_bridge.FALLBACK_EVENTS.cursor()
    got = op.with_backend("pallas")(*args)
    ev = pallas_bridge.FALLBACK_EVENTS.since(cur)
    if expect_lower:
        assert not ev, ev
    assert _ranges(ref) == _ranges(got)
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=rtol, atol=0)
    return got


def test_concat_where_simple_split():
    from gt4py_tpu.next import concat_where

    @gtx.field_operator
    def bc(a: F64, b: F64):
        return concat_where(K < 2, a * 2.0, b + 1.0)

    a = gtx.as_field((I, J, K), _rand((8, 6, 10), 50))
    b = gtx.as_field((I, J, K), _rand((8, 6, 10), 51))
    _check_cw(bc, a, b)


def test_concat_where_boundary_reads_interior_at_k_minus_1():
    """The classic boundary-condition pattern: the interior branch reads
    K-1, legal only because the sections restrict it to K >= 1 (a
    pointwise select would read out of bounds at K=0)."""
    from gt4py_tpu.next import concat_where

    @gtx.field_operator
    def bc(a: F64):
        return concat_where(K < 1, a * 10.0, a(Koff[-1]) + a)

    a = gtx.as_field((I, J, K), _rand((8, 6, 10), 52))
    _check_cw(bc, a)


def test_concat_where_branch_via_temp_statement():
    """The interior branch computed in a SEPARATE statement: per-section
    dead-code elimination must drop it from the surface section, where
    its K-1 read would be out of bounds (r4 verify finding)."""
    from gt4py_tpu.next import concat_where

    @gtx.field_operator
    def column_bc(t: F64, t_sfc: F64) -> F64:
        interior = 0.5 * (t(Koff[-1]) + t)
        return concat_where(K < 1, t_sfc * 1.0, interior)

    t = gtx.as_field((I, J, K), _rand((10, 8, 12), 62))
    sfc = gtx.as_field((I, J, K), _rand((10, 8, 12), 63))
    _check_cw(column_bc, t, sfc)


def test_concat_where_nested_and_double():
    from gt4py_tpu.next import concat_where

    @gtx.field_operator
    def bc(a: F64, b: F64):
        t = concat_where(K >= 3, a(Ioff[1]) - b, where(a > 0.5, b, a))
        return t * 0.5 + concat_where(K <= 6, a, b)

    a = gtx.as_field((I, J, K), _rand((8, 6, 10), 53))
    b = gtx.as_field((I, J, K), _rand((8, 6, 10), 54))
    _check_cw(bc, a, b)


def test_concat_where_scalar_branch():
    from gt4py_tpu.next import concat_where

    @gtx.field_operator
    def bc(a: F64):
        return concat_where(K < 3, 0.0, a)

    a = gtx.as_field((I, J, K), _rand((8, 6, 10), 55))
    _check_cw(bc, a)


def test_concat_where_extended_domain_falls_back():
    """Branch K shifts whose piece algebra EXTENDS the result beyond the
    input buffer need negative kernel origins -- correctly rejected, and
    the transparent fallback reproduces the embedded extended domain."""
    from gt4py_tpu.next import concat_where

    @gtx.field_operator
    def bc(a: F64):
        return concat_where(K < 5, a(Koff[1]), a(Koff[-1]))

    a = gtx.as_field((I, J, K), _rand((8, 6, 10), 56))
    got = _check_cw(bc, a, expect_lower=False)
    assert _ranges(got)[2] == (-1, 11)


def test_concat_where_horizontal_falls_back():
    from gt4py_tpu.next import concat_where

    @gtx.field_operator
    def bc(a: F64, b: F64):
        return concat_where(I < 4, a, b)

    a = gtx.as_field((I, J, K), _rand((8, 6, 5), 57))
    b = gtx.as_field((I, J, K), _rand((8, 6, 5), 58))
    _check_cw(bc, a, b, expect_lower=False)


def test_concat_where_in_tuple_returns():
    """Tuple members sharing a concat_where temp fuse when their K
    domains agree; members whose piece algebra yields DIFFERENT K
    domains fall back (runtime out-recipe equality gate) -- domains
    and values match the oracle either way."""
    from gt4py_tpu.next import concat_where

    @gtx.field_operator
    def tup_eq(a: F64):
        x = concat_where(K < 2, a * 2.0, a + 1.0)
        return (x + a, x - a)

    @gtx.field_operator
    def tup_diff(a: F64):
        x = concat_where(K < 2, a(Koff[1]), a(Koff[-1]))
        return (x, a * 1.0)

    a = gtx.as_field((I, J, K), _rand((7, 5, 9), 70))
    for op in (tup_eq, tup_diff):
        ref = op.with_backend(backends.numpy_oracle)(a)
        got = op.with_backend("pallas")(a)
        for r, g in zip(ref, got):
            assert _ranges(r) == _ranges(g)
            np.testing.assert_allclose(g.asnumpy(), r.asnumpy(), rtol=1e-13)


def test_concat_where_kernel_path_actually_runs():
    from gt4py_tpu.next import concat_where
    from gt4py_tpu.cartesian.backend import pallas_backend

    @gtx.field_operator
    def bc_probe(a: F64):
        return concat_where(K < 1, a * 10.0, a(Koff[-1]) + a)

    a = gtx.as_field((I, J, K), _rand((8, 6, 10), 59))
    _check_cw(bc_probe, a)
    assert "next_bc_probe" in pallas_backend.LAST_PLAN


# ------------------------- operator-call inlining --------------------------- #


@gtx.field_operator
def _lap(a: F64) -> F64:
    return a(Ioff[1]) + a(Ioff[-1]) + a(Joff[1]) + a(Joff[-1]) - 4.0 * a


def test_inline_operator_composition():
    """lap(lap(a)) inlines into ONE fused kernel with composed extents."""

    @gtx.field_operator
    def laplap(a: F64) -> F64:
        return _lap(_lap(a))

    a = gtx.as_field((I, J, K), _rand((14, 13, 4), 40))
    got = _check(laplap, a)
    assert _ranges(got) == [(2, 12), (2, 11), (0, 4)]


def test_inline_complex_arg_materializes():
    """A computed field argument binds through a hoisted temporary."""

    @gtx.field_operator
    def mixed(a: F64, w: gtx.float64) -> F64:
        l = _lap(a * w + 1.0)
        return l(Ioff[1]) - l

    a = gtx.as_field((I, J, K), _rand((12, 12, 3), 41))
    _check(mixed, a, 0.3)


def test_inline_shifted_call_result():
    """Shifting a call result reads the materialized temp at the offset."""

    @gtx.field_operator
    def sc(a: F64) -> F64:
        return _lap(a)(Ioff[1]) - _lap(a)

    a = gtx.as_field((I, J, K), _rand((11, 11, 3), 42))
    _check(sc, a)


def test_inline_nested_two_levels():
    @gtx.field_operator
    def outer1(a: F64) -> F64:
        return _lap(a) * 0.5

    @gtx.field_operator
    def outer2(a: F64) -> F64:
        return outer1(a(Ioff[1])) + outer1(a)

    a = gtx.as_field((I, J, K), _rand((13, 10, 3), 43))
    _check(outer2, a)


def test_inline_name_collision_with_caller_temp():
    """Callee temp names must not capture same-named caller temps."""

    @gtx.field_operator
    def helper(x: F64) -> F64:
        t = x(Ioff[1]) - x
        return t * 2.0

    @gtx.field_operator
    def caller(a: F64) -> F64:
        t = a * 3.0
        return helper(t) + t

    a = gtx.as_field((I, J, K), _rand((10, 9, 3), 44))
    _check(caller, a)


def test_inline_scan_call_falls_back():
    """Scan-operator calls inside field operators keep the embedded path."""

    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def csum(carry: gtx.float64, x: gtx.float64) -> gtx.float64:
        return carry + x

    @gtx.field_operator
    def uses_scan(a: F64) -> F64:
        return csum(a) + a

    a = gtx.as_field((I, J, K), _rand((8, 8, 5), 45))
    assert _bridge_plan_of(uses_scan, a) is None
    ref = uses_scan.with_backend(backends.numpy_oracle)(a)
    got = uses_scan.with_backend("pallas")(a)
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=1e-13)


def test_bridge_fallbacks_observable():
    """Ineligible operators record (name, reason) in
    pallas_bridge.FALLBACK_EVENTS -- diagnosis parity with the kernel-level
    pallas_backend.FALLBACK_EVENTS."""
    from gt4py_tpu.next import pallas_bridge

    @gtx.field_operator
    def op_obs_probe(a: F64):
        return (a(Ioff[1]) - a, a(Joff[1]) - a)  # differing member extents

    a = gtx.as_field((I, J, K), _rand((9, 9, 3), 46))
    before = len(pallas_bridge.FALLBACK_EVENTS)
    op_obs_probe.with_backend("pallas")(a)
    ev = pallas_bridge.FALLBACK_EVENTS[before:]
    assert any(n == "op_obs_probe" and "extent" in r for n, r in ev), ev


def test_concat_where_half_open_field_domain_plans():
    """ADVICE r4: a field K range infinite on ONE side must contribute
    its finite bound to the piece algebra (previously widened to
    (-INF, INF), always losing fusion).  The unbounded STOP is clamped
    by the other branch's extent, exactly like the embedded executor."""
    from gt4py_tpu.next import concat_where, pallas_bridge
    from gt4py_tpu.next.common import INFINITY, Domain, UnitRange

    U = UnitRange

    @gtx.field_operator
    def bc(a: F64, b: F64):
        return concat_where(K < 2, a * 2.0, b + 1.0)

    adata = _rand((8, 6, 10), 77)
    bdata = _rand((8, 6, 10), 78)

    def mk(wrap):
        a = gtx.as_field((I, J, K), wrap(adata))
        b = Field(
            Domain((I, J, K), (U(0, 8), U(0, 6), U(0, INFINITY))),
            wrap(bdata),
        )
        return a, b

    import jax.numpy as jnp

    ref = bc.with_backend(backends.numpy_oracle)(*mk(np.asarray))
    cur = pallas_bridge.FALLBACK_EVENTS.cursor()
    got = bc.with_backend("pallas")(*mk(jnp.asarray))
    assert not pallas_bridge.FALLBACK_EVENTS.since(cur)
    assert _ranges(got) == _ranges(ref) == [(0, 8), (0, 6), (0, 10)]
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=1e-13, atol=0)


def test_concat_where_unbounded_below_falls_back_cleanly():
    """A K range unbounded BELOW cannot be windowed (data is placed from
    the range start): the bridge must decline with Ineligible -- never
    crash in origin math -- and reproduce the embedded error."""
    from gt4py_tpu.next import concat_where, pallas_bridge
    from gt4py_tpu.next.common import INFINITY, Domain, UnitRange

    U = UnitRange

    @gtx.field_operator
    def bc(a: F64, b: F64):
        return concat_where(K < 2, a * 2.0, b + 1.0)

    adata = _rand((8, 6, 10), 79)
    bdata = _rand((8, 6, 10), 80)

    def mk(wrap):
        a = Field(
            Domain((I, J, K), (U(0, 8), U(0, 6), U(0, INFINITY))),
            wrap(adata),
        )
        b = Field(
            Domain((I, J, K), (U(0, 8), U(0, 6), U(-INFINITY, 10))),
            wrap(bdata),
        )
        return a, b

    import jax.numpy as jnp

    with pytest.raises(Exception) as ref_err:
        bc.with_backend(backends.numpy_oracle)(*mk(np.asarray))
    with pytest.raises(Exception) as got_err:
        bc.with_backend("pallas")(*mk(jnp.asarray))
    # both paths fail with the embedded executor's error, not an
    # OverflowError from the bridge's origin arithmetic
    assert type(got_err.value).__name__ == type(ref_err.value).__name__

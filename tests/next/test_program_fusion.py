"""Whole-program kernel fusion on the next pallas backend.

A multi-statement ``@program`` lowers to ONE fused cartesian Pallas
kernel (intermediate Fields become temporaries) plus thin
restricted runs that complete each intermediate's halo region.
Reference analog: global-temporaries extraction + as_fieldop fusion
(src/gt4py/next/iterator/transforms/global_tmps.py:312,
fuse_as_fieldop.py:245).  The embedded executor is the spec: values,
written regions, and the stale-halo semantics of partially-written
buffers must match on every path.
"""

import warnings

import numpy as np
import pytest

import gt4py_tpu.next as gtx
from gt4py_tpu.next import Dims, Field, backends, concat_where, program, where
from gt4py_tpu.next import pallas_bridge

# kernel numerics for every stencil class, not only the default rule's
pytestmark = pytest.mark.usefixtures("all_kernel_classes")

I = gtx.Dimension("I")
J = gtx.Dimension("J")
K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)
Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
Joff = gtx.FieldOffset("Joff", source=J, target=(J,))
Koff = gtx.FieldOffset("Koff", source=K, target=(K,))
F = Field[Dims[I, J, K], gtx.float64]
U = gtx.UnitRange

N, M, NK = 24, 20, 5


def _fld(ilo, ihi, jlo, jhi, seed=None, nk=NK):
    shape = (ihi - ilo, jhi - jlo, nk)
    data = (
        np.random.default_rng(seed).random(shape)
        if seed is not None
        else np.zeros(shape)
    )
    dom = gtx.Domain((I, J, K), (U(ilo, ihi), U(jlo, jhi), U(0, nk)))
    return gtx.Field(dom, data)


@gtx.field_operator
def lap_op(a: F) -> F:
    return a(Ioff[1]) + a(Ioff[-1]) + a(Joff[1]) + a(Joff[-1]) - 4.0 * a


@gtx.field_operator
def flx_op(a: F, lap: F) -> F:
    fx = lap(Ioff[1]) - lap
    return where(fx * (a(Ioff[1]) - a) > 0.0, 0.0, fx)


@gtx.field_operator
def fly_op(a: F, lap: F) -> F:
    fy = lap(Joff[1]) - lap
    return where(fy * (a(Joff[1]) - a) > 0.0, 0.0, fy)


@gtx.field_operator
def out_op(a: F, fx: F, fy: F, coeff: F) -> F:
    return a - coeff * (fx - fx(Ioff[-1]) + fy - fy(Joff[-1]))


@program
def hdiff_prog(a: F, coeff: F, lap: F, fx: F, fy: F, out: F):
    lap_op(a, out=lap)
    flx_op(a, lap, out=fx)
    fly_op(a, lap, out=fy)
    out_op(a, fx, fy, coeff, out=out)


def _hdiff_args():
    return [
        _fld(-2, N + 2, -2, M + 2, seed=7),
        _fld(0, N, 0, M, seed=8),
        _fld(-1, N + 1, -1, M + 1),
        _fld(-1, N, -1, M + 1),
        _fld(-1, N + 1, -1, M),
        _fld(0, N, 0, M),
    ]


def _fused_plan(prog):
    """The FIRST fused segment's ProgramBridgePlan (None = nothing fused)."""
    plans = prog.__dict__.get("_prog_bridge_plans", {})
    sched = next((v for v in plans.values() if v is not None), None)
    if sched is None:
        return None
    return next((p for k, p in sched.items if k == "fused"), None)


def _schedule(prog):
    plans = prog.__dict__.get("_prog_bridge_plans", {})
    return next((v for v in plans.values() if v is not None), None)


def test_hdiff_program_fuses_into_one_kernel():
    """The flagship: lap -> flx/fly -> out as a program of small
    operators runs as ONE kernel; every buffer (including the
    halo-extended lap/fx/fy intermediates) matches the oracle."""
    refs = _hdiff_args()
    hdiff_prog.with_backend(backends.numpy_oracle)(*refs)

    gots = _hdiff_args()
    cur = pallas_bridge.FALLBACK_EVENTS.cursor()
    p = hdiff_prog.with_backend("pallas")
    p(*gots)
    assert not pallas_bridge.FALLBACK_EVENTS.since(cur)
    for name, r, g in zip(("lap", "fx", "fy", "out"), refs[2:], gots[2:]):
        np.testing.assert_allclose(
            g.asnumpy(), r.asnumpy(), rtol=1e-12, atol=0, err_msg=name
        )
    pplan = _fused_plan(p)
    assert pplan is not None
    inst = next(
        v for v in pplan.instances.values() if not isinstance(v, Exception)
    )
    # one kernel over the out domain; halo strips only for the extended
    # intermediates (lap: 4, flx/fly: 3 each, out: none)
    assert inst.domain == (N, M, NK)
    assert [[len(m.strips) for m in w] for w in inst.stmt_writes] == [
        [4],
        [3],
        [3],
        [0],
    ]


def test_fused_program_runs_through_aot_pool_jit():
    """Second call with identical domains reuses the cached instance; a
    different domain signature builds a new one (no wrong-shape reuse)."""
    p = hdiff_prog.with_backend("pallas")
    args = _hdiff_args()
    p(*args)
    p(*args)  # cache hit
    pplan = _fused_plan(p)
    n_inst = len(pplan.instances)
    # shifted domains: new signature
    shift = [
        _fld(-1, N + 3, -2, M + 2, seed=7),
        _fld(1, N + 1, 0, M, seed=8),
        _fld(0, N + 2, -1, M + 1),
        _fld(0, N + 1, -1, M + 1),
        _fld(0, N + 2, -1, M),
        _fld(1, N + 1, 0, M),
    ]
    refs = [f for f in shift]
    hdiff_prog.with_backend(backends.numpy_oracle)(
        *[gtx.Field(f.domain, np.array(f.asnumpy())) for f in refs]
    )
    p(*shift)
    assert len(pplan.instances) == n_inst + 1


@gtx.field_operator
def pair_op(a: F) -> tuple[F, F]:
    mid = a(Ioff[1]) + a(Ioff[-1]) - 2.0 * a
    return (mid + a, mid - a)


@gtx.field_operator
def scale_op(x: F, s: gtx.float64) -> F:
    return x * s


@program
def tuple_slice_prog(a: F, p1: F, p2: F, o: F):
    pair_op(a, out=(p1, p2))
    scale_op(p1, 3.0, out=o[1:-1, 1:-1], domain={I: (2, 14), J: (2, 12), K: (0, 4)})


def test_tuple_statement_slice_target_and_static_domain():
    n, m, nk = 16, 14, 4

    def run(backend):
        a = _fld(-1, n + 1, 0, m, seed=3, nk=nk)
        p1 = _fld(0, n, 0, m, nk=nk)
        p2 = _fld(0, n, 0, m, nk=nk)
        o = _fld(0, n, 0, m, nk=nk)
        pr = tuple_slice_prog.with_backend(backend)
        pr(a, p1, p2, o)
        return [p1, p2, o], pr

    cur = pallas_bridge.FALLBACK_EVENTS.cursor()
    refs, _ = run(backends.numpy_oracle)
    gots, pr = run("pallas")
    assert not pallas_bridge.FALLBACK_EVENTS.since(cur)
    assert _fused_plan(pr) is not None
    for name, r, g in zip(("p1", "p2", "o"), refs, gots):
        np.testing.assert_allclose(
            g.asnumpy(), r.asnumpy(), rtol=1e-12, atol=0, err_msg=name
        )


@gtx.field_operator
def incr_op(x: F) -> F:
    return x + 1.0


@program
def rewrite_prog(a: F, t: F, o: F):
    incr_op(a, out=t)
    incr_op(t, out=t)
    scale_op(t, 0.5, out=o)


def test_repeated_writes_to_same_param():
    def run(backend):
        a = _fld(0, N, 0, M, seed=9)
        t = _fld(0, N, 0, M)
        o = _fld(0, N, 0, M)
        rewrite_prog.with_backend(backend)(a, t, o)
        return [t, o]

    cur = pallas_bridge.FALLBACK_EVENTS.cursor()
    refs = run(backends.numpy_oracle)
    gots = run("pallas")
    assert not pallas_bridge.FALLBACK_EVENTS.since(cur)
    for name, r, g in zip(("t", "o"), refs, gots):
        np.testing.assert_allclose(
            g.asnumpy(), r.asnumpy(), rtol=1e-12, atol=0, err_msg=name
        )


@program
def stale_prog(a: F, lap: F, fx: F):
    lap_op(a, out=lap, domain={I: (0, 24), J: (0, 20), K: (0, 5)})
    flx_op(a, lap, out=fx)


def test_stale_halo_read_falls_back_and_matches():
    """fx's statement reads lap at I+1 beyond the region lap_op wrote
    (lap's buffer is bigger than its written region, so the embedded
    path reads the ORIGINAL zeros there).  The fused kernel would read
    formula values instead -- the gate must reject and fall back."""

    def run(backend):
        a = _fld(-1, N + 1, -1, M + 1, seed=4)
        lap = _fld(-5, N + 5, -5, M + 5)  # big, zero-init, written [0,N)
        fx = _fld(0, N, 0, M)  # its statement reads lap over I [0, N+1)
        stale_prog.with_backend(backend)(a, lap, fx)
        return [lap, fx]

    cur = pallas_bridge.FALLBACK_EVENTS.cursor()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        refs = run(backends.numpy_oracle)
        gots = run("pallas")
    ev = pallas_bridge.FALLBACK_EVENTS.since(cur)
    assert any("program fusion" in e[1] for e in ev), ev
    for name, r, g in zip(("lap", "fx"), refs, gots):
        np.testing.assert_allclose(
            g.asnumpy(), r.asnumpy(), rtol=1e-12, atol=0, err_msg=name
        )


@gtx.scan_operator(axis=K, forward=True, init=0.0)
def cumsum_op(carry: gtx.float64, x: gtx.float64) -> gtx.float64:
    return carry + x


@program
def scan_prog(a: F, c: F, o: F):
    cumsum_op(a, out=c)
    scale_op(c, 2.0, out=o)


def test_scan_then_op_program_fuses():
    """r5 (VERDICT r4 #3): a scan followed by an operator IS a fusible
    run -- the scan loop and the scale statement execute as one kernel
    (pre-r5 this program had no fusible run at all)."""

    def run(backend):
        a = _fld(0, N, 0, M, seed=5)
        c = _fld(0, N, 0, M)
        o = _fld(0, N, 0, M)
        prog = scan_prog.with_backend(backend)
        prog(a, c, o)
        return prog, [c, o]

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, refs = run(backends.numpy_oracle)
        cur = pallas_bridge.FALLBACK_EVENTS.cursor()
        p, gots = run("pallas")
        assert not pallas_bridge.FALLBACK_EVENTS.since(cur)
    sched = _schedule(p)
    assert sched is not None
    assert [k for k, _ in sched.items] == ["fused"]
    assert [ps.is_scan for ps in sched.items[0][1].stmts] == [True, False]
    for name, r, g in zip(("c", "o"), refs, gots):
        np.testing.assert_allclose(
            g.asnumpy(), r.asnumpy(), rtol=1e-12, atol=0, err_msg=name
        )


@program
def mixed_prog(a: F, lap: F, fx: F, c: F, out: F):
    # fusible run 1 (2 statements) -- interp scan -- trailing statement
    lap_op(a, out=lap)
    flx_op(a, lap, out=fx)
    cumsum_op(fx, out=c)
    incr_op(c, out=out)


def test_mixed_program_fuses_maximal_runs():
    """r4: the lap->flx run fused and the scan interrupted the segment.
    r5 (VERDICT r4 #3): the scan statement JOINS the fused kernel as its
    own serial vertical loop, so the whole lap->flx->cumsum->incr
    program is ONE kernel -- cross-statement temps never round-trip
    through HBM at a scan boundary."""

    def run(backend):
        a = _fld(-2, N + 2, -2, M + 2, seed=11)
        lap = _fld(-1, N + 1, -1, M + 1)
        fx = _fld(-1, N, -1, M + 1)
        c = _fld(-1, N, -1, M + 1)
        out = _fld(-1, N, -1, M + 1)
        mixed_prog.with_backend(backend)(a, lap, fx, c, out)
        return [lap, fx, c, out]

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        refs = run(backends.numpy_oracle)
        p = mixed_prog.with_backend("pallas")
        a = _fld(-2, N + 2, -2, M + 2, seed=11)
        gots = [
            _fld(-1, N + 1, -1, M + 1),
            _fld(-1, N, -1, M + 1),
            _fld(-1, N, -1, M + 1),
            _fld(-1, N, -1, M + 1),
        ]
        cur = pallas_bridge.FALLBACK_EVENTS.cursor()
        p(a, *gots)
        # the CALL itself must fuse (a structural "fused" schedule alone
        # can still fall back per call)
        assert not pallas_bridge.FALLBACK_EVENTS.since(cur)
    sched = _schedule(p)
    kinds = [k for k, _ in sched.items]
    assert kinds == ["fused"], kinds
    assert len(sched.items[0][1].stmts) == 4
    assert [ps.is_scan for ps in sched.items[0][1].stmts] == [
        False,
        False,
        True,
        False,
    ]
    for name, r, g in zip(("lap", "fx", "c", "out"), refs, gots):
        np.testing.assert_allclose(
            g.asnumpy(), r.asnumpy(), rtol=1e-12, atol=0, err_msg=name
        )


def test_single_statement_program_uses_per_operator_path_quietly():
    @program
    def single(a: F, o: F):
        lap_op(a, out=o)

    a = _fld(-1, N + 1, -1, M + 1, seed=6)
    o_ref, o_got = _fld(0, N, 0, M), _fld(0, N, 0, M)
    single.with_backend(backends.numpy_oracle)(a, o_ref)
    from gt4py_tpu import config

    config._warned_fallbacks.clear()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        single.with_backend("pallas")(
            gtx.Field(a.domain, np.array(a.asnumpy())), o_got
        )
    assert not [
        w for w in rec if issubclass(w.category, config.PerformanceFallbackWarning)
    ]
    np.testing.assert_allclose(o_got.asnumpy(), o_ref.asnumpy(), rtol=1e-12)


@program
def shadow_prog(a: F, lap: F, fx: F, fy: F):
    # the local assignment rebinds `a` for everything after it -- a
    # fused segment binding the ORIGINAL parameter would diverge
    lap_op(a, out=lap)
    a = lap  # noqa: F841 -- shadows the parameter
    flx_op(a, lap, out=fx)
    fly_op(a, lap, out=fy)


def test_param_shadowing_assignment_blocks_fusion():
    """ADVICE r4: an interpreted assignment whose target shadows a
    program parameter must demote later fused segments that bind that
    name (they'd silently keep the original parameter while interpreted
    statements see the local)."""

    def run(backend):
        a = _fld(-2, N + 2, -2, M + 2, seed=21)
        lap = _fld(-1, N + 1, -1, M + 1)
        fx = _fld(-1, N, -1, M + 1)
        fy = _fld(-1, N + 1, -1, M)
        shadow_prog.with_backend(backend)(a, lap, fx, fy)
        return [lap, fx, fy]

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        refs = run(backends.numpy_oracle)
        gots = run("pallas")
    for name, r, g in zip(("lap", "fx", "fy"), refs, gots):
        np.testing.assert_allclose(
            g.asnumpy(), r.asnumpy(), rtol=1e-12, atol=0, err_msg=name
        )


@program
def fresh_local_prog(a: F, lap: F, fx: F, fy: F):
    lap_op(a, out=lap)
    unused = lap  # noqa: F841 -- fresh name: no parameter shadowed
    flx_op(a, lap, out=fx)
    fly_op(a, lap, out=fy)


def test_fresh_local_assignment_keeps_fusion():
    """A non-colliding local assignment must NOT cost fusion: the
    flx/fly run after it still fuses."""

    def run(backend):
        a = _fld(-2, N + 2, -2, M + 2, seed=22)
        lap = _fld(-1, N + 1, -1, M + 1)
        fx = _fld(-1, N, -1, M + 1)
        fy = _fld(-1, N + 1, -1, M)
        shadow = fresh_local_prog.with_backend(backend)
        shadow(a, lap, fx, fy)
        return shadow, [lap, fx, fy]

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, refs = run(backends.numpy_oracle)
        p, gots = run("pallas")
    sched = _schedule(p)
    assert sched is not None
    kinds = [k for k, _ in sched.items]
    assert "fused" in kinds, kinds
    for name, r, g in zip(("lap", "fx", "fy"), refs, gots):
        np.testing.assert_allclose(
            g.asnumpy(), r.asnumpy(), rtol=1e-12, atol=0, err_msg=name
        )


@gtx.scan_operator(axis=K, forward=False, init=(0.0, 1.0))
def back_tuple_scan(
    carry: tuple[gtx.float64, gtx.float64], x: gtx.float64
) -> tuple[gtx.float64, gtx.float64]:
    return (carry[0] + x, carry[1] * 0.5 + x)


@program
def back_prog(a: F, s: F, p: F, o: F):
    back_tuple_scan(a, out=(s, p))
    scale_op(s, 3.0, out=o)


def test_backward_tuple_scan_fuses():
    """BACKWARD order and tuple carries splice like forward scalars
    (two serial out temps, then the parallel consumer)."""

    def run(backend):
        a = _fld(0, N, 0, M, seed=31)
        s = _fld(0, N, 0, M)
        p = _fld(0, N, 0, M)
        o = _fld(0, N, 0, M)
        prog = back_prog.with_backend(backend)
        prog(a, s, p, o)
        return prog, [s, p, o]

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, refs = run(backends.numpy_oracle)
        cur = pallas_bridge.FALLBACK_EVENTS.cursor()
        pr, gots = run("pallas")
        assert not pallas_bridge.FALLBACK_EVENTS.since(cur)
    sched = _schedule(pr)
    assert sched is not None and [k for k, _ in sched.items] == ["fused"]
    for name, r, g in zip(("s", "p", "o"), refs, gots):
        np.testing.assert_allclose(
            g.asnumpy(), r.asnumpy(), rtol=1e-12, atol=0, err_msg=name
        )


@program
def scan_trunc_prog(a: F, c: F, o: F):
    cumsum_op(a, out=c)
    scale_op(c, 2.0, out=o, domain={I: (0, 24), J: (0, 20), K: (1, 4)})


def test_truncating_scan_k_domain_falls_back():
    """A statement restricting the fused K domain below the scan's write
    region must NOT truncate the scan (different computation): the
    instance declines and the per-statement path preserves numerics."""

    def run(backend):
        a = _fld(0, N, 0, M, seed=33)
        c = _fld(0, N, 0, M)
        o = _fld(0, N, 0, M)
        scan_trunc_prog.with_backend(backend)(a, c, o)
        return [c, o]

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        refs = run(backends.numpy_oracle)
        gots = run("pallas")
    for name, r, g in zip(("c", "o"), refs, gots):
        np.testing.assert_allclose(
            g.asnumpy(), r.asnumpy(), rtol=1e-12, atol=0, err_msg=name
        )


# ------------------- concat_where statements in fusion ------------------- #


@gtx.field_operator
def interior_lap(t: F) -> F:
    return t(Ioff[1]) + t(Ioff[-1]) - 2.0 * t


@gtx.field_operator
def bc_op(lap: F, sfc: F) -> F:
    return concat_where(K < 1, sfc * 10.0, lap(Koff[-1]) + lap)


@gtx.field_operator
def half_op(t: F, b: F) -> F:
    return t - 0.5 * b


@program
def bc_prog(t: F, sfc: F, lap: F, b: F, o: F):
    interior_lap(t, out=lap, domain={I: (0, 24), J: (0, 20), K: (0, 5)})
    bc_op(lap, sfc, out=b)
    half_op(t, b, out=o)


def test_concat_where_statement_fuses():
    """VERDICT r4 #5: the boundary-condition pattern -- interior stencil,
    concat_where surface/interior select (whose interior branch reads
    K-1, legal only through the K sections), pointwise update -- fuses
    into ONE kernel; parity is exact vs the embedded oracle."""

    def run(backend):
        t = _fld(-1, N + 1, 0, M, seed=41)
        sfc = _fld(0, N, 0, M, seed=42)
        lap = gtx.Field(
            gtx.Domain((I, J, K), (U(0, N), U(0, M), U(-1, NK))),
            np.zeros((N, M, NK + 1)),
        )
        b = _fld(0, N, 0, M)
        o = _fld(0, N, 0, M)
        prog = bc_prog.with_backend(backend)
        prog(t, sfc, lap, b, o)
        return prog, [lap, b, o]

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, refs = run(backends.numpy_oracle)
        cur = pallas_bridge.FALLBACK_EVENTS.cursor()
        pr, gots = run("pallas")
        assert not pallas_bridge.FALLBACK_EVENTS.since(cur)
    sched = _schedule(pr)
    assert sched is not None and [k for k, _ in sched.items] == ["fused"]
    assert [ps.is_cw for ps in sched.items[0][1].stmts] == [False, True, False]
    for name, r, g in zip(("lap", "b", "o"), refs, gots):
        np.testing.assert_allclose(
            g.asnumpy(), r.asnumpy(), rtol=1e-12, atol=0, err_msg=name
        )


@gtx.field_operator
def cw_plain_op(a: F) -> F:
    return concat_where(K < 1, a * 10.0, a + 1.0)


@program
def cw_mismatch_prog(a: F, c: F, o: F):
    # the cw statement's K window [0, NK) differs from the second
    # statement's restricted K domain -> per-call fallback, same values
    cw_plain_op(a, out=c)
    scale_op(c, 2.0, out=o, domain={I: (0, 24), J: (0, 20), K: (1, 4)})


def test_concat_where_k_window_mismatch_falls_back():
    def run(backend):
        a = _fld(0, N, 0, M, seed=43)
        c = _fld(0, N, 0, M)
        o = _fld(0, N, 0, M)
        cw_mismatch_prog.with_backend(backend)(a, c, o)
        return [c, o]

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        refs = run(backends.numpy_oracle)
        gots = run("pallas")
    for name, r, g in zip(("c", "o"), refs, gots):
        np.testing.assert_allclose(
            g.asnumpy(), r.asnumpy(), rtol=1e-12, atol=0, err_msg=name
        )

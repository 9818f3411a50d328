"""Benchmark: times the stencil workloads on one GPU and prints
ONE JSON line.

Headline: grid points per second over the dycore (horizontal diffusion +
vertical advection with tridiagonal scans) and FVTP2D advection steps at
512^2 x 80 f32.  Each workload is iterated inside one jit
(``lax.fori_loop``) and timed once at two iteration counts; the
per-iteration time is the slope, which cancels dispatch, readback and
compilation.

``--backend pallas`` (default) runs the ``pallas`` backend with its class
rule; ``--backend kernel`` sends every stencil class to the column kernel;
``--backend jax`` runs the XLA executor.  The script needs a GPU: without
one it raises and prints no number.  A row that fails is named under
``failed_rows`` with no number, and the exit code is 1.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

NI, NJ, NK = 512, 512, 80
HALO = 3
DTYPE = np.float32

#: executor of the cartesian model rows (see --backend)
BACKEND = "pallas"


def _build_state(model):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in model.init_state(seed=3).items()}


def _slope(timed, i1: int, i2: int) -> float:
    """Per-iteration time from one run at each of two iteration counts;
    raises when the host clock's noise exceeds the difference."""
    t1, t2 = timed(i1), timed(i2)
    per = (t2 - t1) / (i2 - i1)
    if per <= 0:
        raise RuntimeError(f"non-positive slope ({t1:.6f} s, {t2:.6f} s)")
    return per


def _time_once(run, *args) -> float:
    """Seconds of one call of ``run`` after a warm-up call (compile)."""
    float(run(*args))
    t0 = time.perf_counter()
    float(run(*args))
    return time.perf_counter() - t0


def _timed_loop(step_fn, state, iters, sum_keys=("u",)):
    """Time `iters` applications of step_fn composed inside one jit.

    ``sum_keys`` must cover every independent computation chain in the
    step -- anything the final readback does not observe is dead code
    XLA deletes (and the bench then under-reports)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(state):
        def body(_, s):
            return step_fn(s)

        final = jax.lax.fori_loop(0, iters, body, state)
        return sum(jnp.sum(final[k]) for k in sum_keys)

    return _time_once(run, state)


def bench_dycore(dtype=None):
    """Per-iteration time of the fused hdiff+vadv+update step on device."""
    from gt4py_tpu.models import MiniDycore

    model = MiniDycore(NI, NJ, NK, dtype=dtype or DTYPE, backend=BACKEND)
    step = model.step_fn()
    state = _build_state(model)

    i1, i2 = 3, 15
    return _slope(lambda n: _timed_loop(step, state, n), i1, i2)


def bench_fv(dtype=None):
    """Per-iteration time of the FVTP2D advection step on device."""
    import jax
    import jax.numpy as jnp

    from gt4py_tpu.models import FvAdvection

    model = FvAdvection(NI, NJ, NK, dtype=dtype or DTYPE, backend=BACKEND)
    st = {k: jnp.asarray(v) for k, v in model.init_state(seed=4).items()}
    st["cx"], st["cy"] = model.fill_winds(st["cx"], st["cy"])
    fv_step = model.step_fn(winds_filled=True)

    def step(state):
        q = fv_step(state["q"], state["cx"], state["cy"])
        new = dict(state)
        new["q"] = q
        new["u"] = q  # reuse the _timed_loop harness (sums state["u"])
        return new

    st["u"] = st["q"]
    i1, i2 = 3, 15
    return _slope(lambda n: _timed_loop(step, st, n), i1, i2)


def bench_full_dycore():
    """Per-iteration time of the FullDycore step (dycore + FV tracer +
    semi-Lagrangian tracer) at 512^2 x 80."""
    from gt4py_tpu.models.full_dycore import FullDycore

    model = FullDycore(NI, NJ, NK, dtype=DTYPE, backend=BACKEND)
    step = model.step_fn()
    state = _build_state(model)
    i1, i2 = 3, 9
    # sum ALL prognostic chains: u (dycore), q (FV), qsl (semi-Lagrangian)
    # are independent -- summing only u lets XLA dead-code the tracers
    keys = ("u", "q", "qsl")
    return _slope(
        lambda n: _timed_loop(step, state, n, sum_keys=keys), i1, i2
    )


def bench_fv_1024():
    """FVTP2D at the 1024^2 x 80 scale (BASELINE large-grid row)."""
    import jax.numpy as jnp

    from gt4py_tpu.models import FvAdvection

    model = FvAdvection(1024, 1024, NK, dtype=DTYPE, backend=BACKEND)
    st = {k: jnp.asarray(v) for k, v in model.init_state(seed=4).items()}
    st["cx"], st["cy"] = model.fill_winds(st["cx"], st["cy"])
    fv_step = model.step_fn(winds_filled=True)

    def step(state):
        q = fv_step(state["q"], state["cx"], state["cy"])
        new = dict(state)
        new["q"] = q
        new["u"] = q
        return new

    st["u"] = st["q"]
    i1, i2 = 3, 9
    return _slope(lambda n: _timed_loop(step, st, n), i1, i2)


def bench_next_hdiff():
    """Horizontal diffusion written in the NEXT field-view DSL at
    512^2 x 80 f32: the parsed/typed operator stages under jit into one
    fused XLA program (periodic wrap re-pad between iterations)."""
    import jax
    import jax.numpy as jnp

    import gt4py_tpu.next as gtx
    from gt4py_tpu.next import Dims, Field, where

    I = gtx.Dimension("I")
    J = gtx.Dimension("J")
    K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)
    Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
    Joff = gtx.FieldOffset("Joff", source=J, target=(J,))
    FT = Field[Dims[I, J, K], gtx.float32]

    @gtx.field_operator
    def hdiff(inp: FT, coeff: FT) -> FT:
        lap = 4.0 * inp - (
            inp(Ioff[1]) + inp(Ioff[-1]) + inp(Joff[1]) + inp(Joff[-1])
        )
        flx = lap(Ioff[1]) - lap
        flx = where(flx * (inp(Ioff[1]) - inp) > 0.0, 0.0, flx)
        fly = lap(Joff[1]) - lap
        fly = where(fly * (inp(Joff[1]) - inp) > 0.0, 0.0, fly)
        return inp - coeff * (
            flx - flx(Ioff[-1]) + fly - fly(Joff[-1])
        )

    h = 2
    rng = np.random.default_rng(5)
    inp = jnp.asarray(
        rng.random((NI + 2 * h, NJ + 2 * h, NK)).astype("float32")
    )
    coeff = jnp.asarray(
        0.025 * rng.random((NI + 2 * h, NJ + 2 * h, NK)).astype("float32")
    )
    cf = gtx.as_field((I, J, K), coeff)

    def step(arr):
        out = hdiff(gtx.as_field((I, J, K), arr), cf)  # domain shrinks by h
        return jnp.pad(out.data, ((h, h), (h, h), (0, 0)), mode="wrap")

    import functools

    @functools.partial(jax.jit, static_argnums=1)
    def run(arr, iters):
        return jnp.sum(
            jax.lax.fori_loop(0, iters, lambda _, a: step(a), arr)
        )

    def timed(iters):
        return _time_once(run, inp, iters)

    i1, i2 = 3, 15
    return _slope(timed, i1, i2)


def bench_next_hdiff_pallas():
    """The same next-DSL hdiff through the pallas bridge
    (next/pallas_bridge.py): the typed field-view IR lowers to a fused
    cartesian stencil; the halo geometry + out=/domain= pin the
    compute domain exactly like the cartesian bench."""
    import jax
    import jax.numpy as jnp

    import gt4py_tpu.next as gtx
    from gt4py_tpu.next import Dims, Field, where
    from gt4py_tpu.next.common import Domain, UnitRange

    OI = OJ = HALO
    SI, SJ = NI + 2 * HALO, NJ + 2 * HALO

    I = gtx.Dimension("I")
    J = gtx.Dimension("J")
    K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)
    Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
    Joff = gtx.FieldOffset("Joff", source=J, target=(J,))
    FT = Field[Dims[I, J, K], gtx.float32]

    @gtx.field_operator
    def hdiff(inp: FT, coeff: FT) -> FT:
        lap = 4.0 * inp - (
            inp(Ioff[1]) + inp(Ioff[-1]) + inp(Joff[1]) + inp(Joff[-1])
        )
        flx = lap(Ioff[1]) - lap
        flx = where(flx * (inp(Ioff[1]) - inp) > 0.0, 0.0, flx)
        fly = lap(Joff[1]) - lap
        fly = where(fly * (inp(Joff[1]) - inp) > 0.0, 0.0, fly)
        return inp - coeff * (flx - flx(Ioff[-1]) + fly - fly(Joff[-1]))

    rng = np.random.default_rng(5)
    inp0 = jnp.asarray(rng.random((SI, SJ, NK)).astype("float32"))
    coeff = gtx.as_field(
        (I, J, K),
        jnp.asarray(0.025 * rng.random((SI, SJ, NK)).astype("float32")),
    )
    dom = Domain(
        (I, J, K),
        (UnitRange(OI, OI + NI), UnitRange(OJ, OJ + NJ), UnitRange(0, NK)),
    )
    op = hdiff.with_backend("pallas")
    h = 2

    def step(arr):
        res = gtx.as_field((I, J, K), jnp.zeros_like(arr))
        op(gtx.as_field((I, J, K), arr), coeff, out=res, domain=dom)
        a = res.data
        a = a.at[OI - h : OI].set(a[OI + NI - h : OI + NI])
        a = a.at[OI + NI : OI + NI + h].set(a[OI : OI + h])
        a = a.at[:, OJ - h : OJ].set(a[:, OJ + NJ - h : OJ + NJ])
        a = a.at[:, OJ + NJ : OJ + NJ + h].set(a[:, OJ : OJ + h])
        return a

    def timed(iters):
        @jax.jit
        def run(arr):
            import jax.lax as lax

            return jnp.sum(
                lax.fori_loop(0, iters, lambda _, a: step(a), arr)
            )

        return _time_once(run, inp0)

    i1, i2 = 3, 15
    return _slope(timed, i1, i2)


def bench_next_hdiff_program(fused: bool = True):
    """hdiff written as a 4-statement next-DSL PROGRAM (lap -> flx/fly ->
    out, each a small operator writing a user-visible intermediate
    Field).  ``fused=True`` runs it through program fusion
    (pallas_bridge.lower_program: one fused stencil + thin halo strips);
    ``fused=False`` disables fusion so every statement pays its own
    kernel + HBM round trip -- the r3 behavior this row exists to beat."""
    import jax
    import jax.numpy as jnp

    import gt4py_tpu.next as gtx
    from gt4py_tpu import config as _cfg
    from gt4py_tpu.next import Dims, Field, program, where
    from gt4py_tpu.next.common import Domain, UnitRange

    OI = OJ = HALO
    SI, SJ = NI + 2 * HALO, NJ + 2 * HALO

    I = gtx.Dimension("I")
    J = gtx.Dimension("J")
    K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)
    Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
    Joff = gtx.FieldOffset("Joff", source=J, target=(J,))
    FT = Field[Dims[I, J, K], gtx.float32]

    @gtx.field_operator
    def lap_op(inp: FT) -> FT:
        return 4.0 * inp - (
            inp(Ioff[1]) + inp(Ioff[-1]) + inp(Joff[1]) + inp(Joff[-1])
        )

    @gtx.field_operator
    def flx_op(inp: FT, lap: FT) -> FT:
        fx = lap(Ioff[1]) - lap
        return where(fx * (inp(Ioff[1]) - inp) > 0.0, 0.0, fx)

    @gtx.field_operator
    def fly_op(inp: FT, lap: FT) -> FT:
        fy = lap(Joff[1]) - lap
        return where(fy * (inp(Joff[1]) - inp) > 0.0, 0.0, fy)

    @gtx.field_operator
    def out_op(inp: FT, fx: FT, fy: FT, coeff: FT) -> FT:
        return inp - coeff * (fx - fx(Ioff[-1]) + fy - fy(Joff[-1]))

    @program
    def hdiff_prog(inp: FT, coeff: FT, lap: FT, fx: FT, fy: FT, res: FT):
        lap_op(inp, out=lap)
        flx_op(inp, lap, out=fx)
        fly_op(inp, lap, out=fy)
        out_op(inp, fx, fy, coeff, out=res)

    rng = np.random.default_rng(5)
    inp0 = jnp.asarray(rng.random((SI, SJ, NK)).astype("float32"))
    U = UnitRange
    full = Domain((I, J, K), (U(0, SI), U(0, SJ), U(0, NK)))
    coeff = gtx.Field(
        full, jnp.asarray(0.025 * rng.random((SI, SJ, NK)).astype("float32"))
    )

    def fld(ilo, ihi, jlo, jhi):
        dom = Domain(
            (I, J, K),
            (
                U(OI - ilo, OI + NI + ihi),
                U(OJ - jlo, OJ + NJ + jhi),
                U(0, NK),
            ),
        )
        return dom, tuple(len(r) for r in dom.ranges)

    # exact halo sizing: lap is consumed at (0,+1) by flx (I) / fly (J);
    # fx/fy are consumed at (-1,0) by the final update
    lap_dom, lap_shape = fld(1, 1, 1, 1)
    fx_dom, fx_shape = fld(1, 0, 0, 0)
    fy_dom, fy_shape = fld(0, 0, 1, 0)
    res_dom, res_shape = fld(0, 0, 0, 0)
    prog = hdiff_prog.with_backend("pallas")
    h = 2

    def step(arr):
        lap = gtx.Field(lap_dom, jnp.zeros(lap_shape, jnp.float32))
        fx = gtx.Field(fx_dom, jnp.zeros(fx_shape, jnp.float32))
        fy = gtx.Field(fy_dom, jnp.zeros(fy_shape, jnp.float32))
        res = gtx.Field(res_dom, jnp.zeros(res_shape, jnp.float32))
        prog(gtx.Field(full, arr), coeff, lap, fx, fy, res)
        a = arr.at[OI : OI + NI, OJ : OJ + NJ].set(res.data)
        a = a.at[OI - h : OI].set(a[OI + NI - h : OI + NI])
        a = a.at[OI + NI : OI + NI + h].set(a[OI : OI + h])
        a = a.at[:, OJ - h : OJ].set(a[:, OJ + NJ - h : OJ + NJ])
        a = a.at[:, OJ + NJ : OJ + NJ + h].set(a[:, OJ : OJ + h])
        return a

    old = _cfg.PROGRAM_FUSION
    _cfg.PROGRAM_FUSION = fused
    try:

        def timed(iters):
            @jax.jit
            def run(arr):
                import jax.lax as lax

                return jnp.sum(
                    lax.fori_loop(0, iters, lambda _, a: step(a), arr)
                )

            return _time_once(run, inp0)

        i1, i2 = 3, 15
        return _slope(timed, i1, i2)
    finally:
        _cfg.PROGRAM_FUSION = old


def bench_next_mixed_program(fused: bool = True):
    """A dycore-shaped MIXED next-DSL program at 512^2x80: horizontal
    laplacian (PARALLEL) -> vertical integration scan (FORWARD serial-K)
    -> pointwise update.  ``fused=True`` runs it as ONE kernel (the scan
    statement joins the fused segment as its own serial vertical loop,
    r5); ``fused=False`` pays a kernel + HBM round trip per statement --
    the r4 behavior where scans broke fusion."""
    import jax
    import jax.numpy as jnp

    import gt4py_tpu.next as gtx
    from gt4py_tpu import config as _cfg
    from gt4py_tpu.next import Dims, Field, program
    from gt4py_tpu.next.common import Domain, UnitRange

    OI = OJ = HALO
    SI, SJ = NI + 2 * HALO, NJ + 2 * HALO

    I = gtx.Dimension("I")
    J = gtx.Dimension("J")
    K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)
    Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
    Joff = gtx.FieldOffset("Joff", source=J, target=(J,))
    FT = Field[Dims[I, J, K], gtx.float32]

    @gtx.field_operator
    def lap_op(inp: FT) -> FT:
        return 4.0 * inp - (
            inp(Ioff[1]) + inp(Ioff[-1]) + inp(Joff[1]) + inp(Joff[-1])
        )

    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def integ(carry: gtx.float32, x: gtx.float32) -> gtx.float32:
        return carry * 0.9 + x

    @gtx.field_operator
    def upd(inp: FT, acc: FT) -> FT:
        return inp - 0.1 * acc

    @program
    def mixed_prog(inp: FT, lap: FT, acc: FT, res: FT):
        lap_op(inp, out=lap)
        integ(lap, out=acc)
        upd(inp, acc, out=res)

    rng = np.random.default_rng(9)
    U = UnitRange
    full = Domain((I, J, K), (U(0, SI), U(0, SJ), U(0, NK)))
    inp0 = jnp.asarray(rng.random((SI, SJ, NK)).astype("float32"))
    interior = Domain(
        (I, J, K), (U(OI, OI + NI), U(OJ, OJ + NJ), U(0, NK))
    )

    def step(arr):
        lap = gtx.Field(interior, jnp.zeros((NI, NJ, NK), jnp.float32))
        acc = gtx.Field(interior, jnp.zeros((NI, NJ, NK), jnp.float32))
        res = gtx.Field(interior, jnp.zeros((NI, NJ, NK), jnp.float32))
        mixed_prog(gtx.Field(full, arr), lap, acc, res)
        return arr.at[OI : OI + NI, OJ : OJ + NJ].set(res.data)

    old = _cfg.PROGRAM_FUSION
    _cfg.PROGRAM_FUSION = fused
    try:

        def timed(iters):
            @jax.jit
            def run(arr):
                import jax.lax as lax

                return jnp.sum(
                    lax.fori_loop(0, iters, lambda _, a: step(a), arr)
                )

            return _time_once(run, inp0)

        i1, i2 = 3, 15
        return _slope(timed, i1, i2)
    finally:
        _cfg.PROGRAM_FUSION = old


def bench_next_tridiag(pallas: bool):
    """next-DSL tridiagonal solve (tuple-carry forward elimination +
    backward substitution scan operators) at 512^2 x 80 f32: the scan
    bridge lowers both scans to serial-K column kernels
    (next/pallas_bridge.lower_scan_operator); ``pallas=False`` times the
    same operators on the jit-staged embedded lax.scan path."""
    import jax
    import jax.numpy as jnp

    import gt4py_tpu.next as gtx
    from gt4py_tpu.next import backends

    I = gtx.Dimension("I")
    J = gtx.Dimension("J")
    K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)

    @gtx.scan_operator(axis=K, forward=True, init=(0.0, 0.0))
    def tri_fwd(carry: tuple[gtx.float32, gtx.float32], a: gtx.float32,
                b: gtx.float32, c: gtx.float32, d: gtx.float32):
        denom = b - a * carry[0]
        cp = c / denom
        dp = (d - a * carry[1]) / denom
        return (cp, dp)

    @gtx.scan_operator(axis=K, forward=False, init=0.0)
    def tri_bwd(carry: gtx.float32, cp: gtx.float32,
                dp: gtx.float32) -> gtx.float32:
        return dp - cp * carry

    be = "pallas" if pallas else backends.jax_jit
    fwd_b = tri_fwd.with_backend(be)
    bwd_b = tri_bwd.with_backend(be)

    rng = np.random.default_rng(9)
    mk = lambda off: gtx.as_field(
        (I, J, K), jnp.asarray(rng.random((NI, NJ, NK)).astype(DTYPE) + off)
    )
    a, b, c = mk(0.0), mk(4.0), mk(0.0)
    d0 = jnp.asarray(rng.random((NI, NJ, NK)).astype(DTYPE))

    def solve(dd):
        cp, dp = fwd_b(a, b, c, gtx.as_field((I, J, K), dd))
        return bwd_b(cp, dp).data

    def timed(iters):
        @jax.jit
        def run(dd):
            return jnp.sum(
                jax.lax.fori_loop(0, iters, lambda _, v: solve(v), dd)
            )

        return _time_once(run, d0)

    i1, i2 = 3, 15
    return _slope(timed, i1, i2)


def bench_unstructured(n: int = 512, irregular: bool = False):
    """Unstructured FVM diffusion step (edge gradient + signed divergence,
    the examples/unstructured_fvm.py operators) on an n x n quad patch
    exposed as connectivity tables: ~2*n^2 gather-heavy edges through the
    jit-staged XLA path (the bridge correctly declines local dims; this
    row gives the gather path a measured number and a documented floor --
    see docs/performance.md 'Unstructured gather path').

    ``irregular=True`` runs the same physics on a SHUFFLED mesh (vertices
    and edges renumbered randomly): the affine window fit provably
    declines, so gathers exercise the sort-routing + Benes-butterfly
    compiled path (next/sort_route.py, next/benes.py) -- the row the r4
    verdict asked for (take-path floor at this scale: ~16 ms, r4)."""
    import jax
    import jax.numpy as jnp

    import gt4py_tpu.next as gtx
    from gt4py_tpu.next import Dims, Field, FieldOffset, backends, neighbor_sum
    from gt4py_tpu.next.testing import (
        E2VDim,
        Edge,
        V2EDim,
        Vertex,
        grid_mesh,
        shuffled_mesh,
    )

    mesh = shuffled_mesh(n, seed=7) if irregular else grid_mesh(n)
    E2V = FieldOffset("E2V", source=Vertex, target=(Edge, E2VDim))
    V2E = FieldOffset("V2E", source=Edge, target=(Vertex, V2EDim))
    f64 = gtx.float32

    @gtx.field_operator
    def gradient(psi: Field[Dims[Vertex], gtx.float32]) -> Field[Dims[Edge], gtx.float32]:
        return psi(E2V[1]) - psi(E2V[0])

    @gtx.field_operator
    def divergence(
        flux: Field[Dims[Edge], gtx.float32],
        sign: Field[Dims[Vertex, V2EDim], gtx.float32],
    ) -> Field[Dims[Vertex], gtx.float32]:
        return neighbor_sum(flux(V2E) * sign, axis=V2EDim)

    provider = {"E2V": mesh.e2v, "V2E": mesh.v2e}
    grad_b = gradient.with_backend(backends.jax_jit)
    div_b = divergence.with_backend(backends.jax_jit)

    t = mesh.v2e.table
    first = mesh.e2v.table[np.clip(t, 0, mesh.n_edges - 1), 0]
    sign_np = np.where(
        t == -1, 0.0, np.where(first == np.arange(mesh.n_vertices)[:, None], 1.0, -1.0)
    ).astype(np.float32)
    sign = gtx.as_field((Vertex, V2EDim), jnp.asarray(sign_np))
    psi0 = jnp.asarray(
        np.random.default_rng(3).random(mesh.n_vertices).astype(np.float32)
    )

    def step(psi_data):
        psi = gtx.as_field((Vertex,), psi_data)
        g = grad_b(psi, offset_provider=provider)
        d = div_b(g, sign, offset_provider=provider)
        return psi_data + 0.05 * d.data

    def timed(iters):
        @jax.jit
        def run(p):
            return jnp.sum(jax.lax.fori_loop(0, iters, lambda _, x: step(x), p))

        return _time_once(run, psi0)

    # short steps: large iteration counts keep the slope well above the
    # host clock's noise
    i1, i2 = 100, 1100
    return _slope(timed, i1, i2), mesh.n_edges


def bench_shallow_water():
    """Multi-layer C-grid shallow water at 512^2 x 80 (one fused kernel:
    momentum + forward-backward continuity, periodic wrap in the DMA)."""
    import jax.numpy as jnp

    from gt4py_tpu.models import ShallowWater

    model = ShallowWater(NI, NJ, NK, dtype=DTYPE, backend=BACKEND)
    st = {k: jnp.asarray(v) for k, v in model.init_state(seed=6).items()}
    sw_step = model.step_fn()

    def step(state):
        h, u, v = sw_step(state["h"], state["u"], state["v"])
        return {"h": h, "u": u, "v": v}

    i1, i2 = 3, 15
    keys = ("h", "u", "v")
    return _slope(
        lambda n: _timed_loop(step, st, n, sum_keys=keys), i1, i2
    )


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def require_gpu():
    """Raise unless JAX's default device is a GPU; returns the devices."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"needs a GPU; JAX found {devs[0].platform} devices only"
        )
    return devs


def main():
    global BACKEND
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("pallas", "kernel", "jax"),
                    default="pallas")
    args = ap.parse_args()

    from gt4py_tpu import config

    config.ensure_jax_config()
    devs = require_gpu()
    print(f"# card: {card_line()}", file=sys.stderr, flush=True)
    if args.backend == "kernel":
        from gt4py_tpu.cartesian.backend import pallas_backend

        pallas_backend.KERNEL_CLASSES = pallas_backend.ALL_CLASSES
    BACKEND = "jax" if args.backend == "jax" else "pallas"

    points = NI * NJ * NK
    extra, failed = {}, []

    def row(name, fn, fmt):
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 -- a failed row is named
            failed.append(name)
            print(f"# row {name} FAILED: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)
            return None
        extra.update(fmt(out))
        print(f"# row {name}: {time.perf_counter() - t0:.1f} s wall",
              file=sys.stderr, flush=True)
        return out

    def gp(t, n=points):
        return round(n / t / 1e9, 3)

    dy = row("dycore", bench_dycore, lambda t: {"dycore_512_ms": round(t * 1e3, 3)})
    fv = row("fv", bench_fv, lambda t: {"fv_512_ms": round(t * 1e3, 3)})
    row("full_dycore", bench_full_dycore, lambda t: {
        "full_dycore_512_ms": round(t * 1e3, 3),
        "full_dycore_512_gpoints": gp(t)})
    row("fv_1024", bench_fv_1024, lambda t: {
        "fv_1024_ms": round(t * 1e3, 3),
        "fv_1024_gpoints": gp(t, 1024 * 1024 * NK)})
    import ml_dtypes

    bf = ml_dtypes.bfloat16
    row("dycore_bf16", lambda: bench_dycore(dtype=bf),
        lambda t: {"dycore_bf16_ms": round(t * 1e3, 3)})
    row("fv_bf16", lambda: bench_fv(dtype=bf),
        lambda t: {"fv_bf16_ms": round(t * 1e3, 3)})
    row("shallow_water", bench_shallow_water, lambda t: {
        "shallow_water_512_ms": round(t * 1e3, 3),
        "shallow_water_512_gpoints": gp(t)})
    row("unstructured_fvm", bench_unstructured, lambda r: {
        "unstructured_fvm_ms": round(r[0] * 1e3, 3),
        "unstructured_fvm_medges_s": round(r[1] / r[0] / 1e6, 1)})
    row("unstructured_fvm_irregular", lambda: bench_unstructured(irregular=True),
        lambda r: {
            "unstructured_fvm_irregular_ms": round(r[0] * 1e3, 3),
            "unstructured_fvm_irregular_medges_s": round(r[1] / r[0] / 1e6, 1)})
    row("next_hdiff", bench_next_hdiff, lambda t: {
        "next_hdiff_512_ms": round(t * 1e3, 3), "next_hdiff_512_gpoints": gp(t)})
    row("next_hdiff_pallas", bench_next_hdiff_pallas, lambda t: {
        "next_hdiff_pallas_512_ms": round(t * 1e3, 3),
        "next_hdiff_pallas_512_gpoints": gp(t)})
    row("next_hdiff_program_fused", lambda: bench_next_hdiff_program(fused=True),
        lambda t: {"next_hdiff_program_fused_512_ms": round(t * 1e3, 3),
                   "next_hdiff_program_fused_512_gpoints": gp(t)})
    row("next_hdiff_program_stmtwise",
        lambda: bench_next_hdiff_program(fused=False),
        lambda t: {"next_hdiff_program_stmtwise_512_ms": round(t * 1e3, 3)})
    row("next_mixed_program_fused", lambda: bench_next_mixed_program(fused=True),
        lambda t: {"next_mixed_program_fused_512_ms": round(t * 1e3, 3)})
    row("next_mixed_program_stmtwise",
        lambda: bench_next_mixed_program(fused=False),
        lambda t: {"next_mixed_program_stmtwise_512_ms": round(t * 1e3, 3)})
    row("next_tridiag_pallas", lambda: bench_next_tridiag(pallas=True),
        lambda t: {"next_tridiag_pallas_512_ms": round(t * 1e3, 3),
                   "next_tridiag_pallas_512_gpoints": gp(t)})
    row("next_tridiag", lambda: bench_next_tridiag(pallas=False),
        lambda t: {"next_tridiag_512_ms": round(t * 1e3, 3)})

    result = {
        "metric": "grid_points_per_second",
        "unit": "Gpoint/s",
        "backend": args.backend,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
        "extra": extra,
        "failed_rows": failed,
    }
    if dy is not None and fv is not None:
        result["value"] = round(2 * points / (dy + fv) / 1e9, 3)
    print(json.dumps(result), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

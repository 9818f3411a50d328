"""gt4py_tpu.next quickstart: operators, scans, concat_where, programs,
and the compiled pallas backend -- runnable end to end.

Covers the surface the reference teaches in its workshop notebooks
(reference: docs/user/next/workshop/), re-written for this framework:
every step checks its result against the numpy oracle backend, and the
compiled steps assert they actually took the kernel path.

Run:  python examples/next_quickstart.py        (JAX_PLATFORMS=cpu to
      force CPU; on a GPU the kernels compile for real)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax

    if "cpu" in os.environ.get("JAX_PLATFORMS", ""):
        jax.config.update("jax_platforms", "cpu")

    import gt4py_tpu.next as gtx
    from gt4py_tpu.next import backends, concat_where, program, where
    from gt4py_tpu.next import pallas_bridge

    # ---- dimensions, offsets, fields ---- #
    I = gtx.Dimension("I")
    J = gtx.Dimension("J")
    K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)
    Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
    Joff = gtx.FieldOffset("Joff", source=J, target=(J,))
    Koff = gtx.FieldOffset("Koff", source=K, target=(K,))
    F = gtx.Field[[I, J, K], gtx.float64]

    n, m, nk = 32, 24, 12
    rng = np.random.default_rng(0)
    U = gtx.UnitRange

    def fld(ilo, ihi, jlo, jhi, data=None):
        dom = gtx.Domain(
            (I, J, K), (U(ilo, n + ihi), U(jlo, m + jhi), U(0, nk))
        )
        shape = tuple(len(r) for r in dom.ranges)
        arr = rng.random(shape) if data is None else np.zeros(shape)
        return gtx.Field(dom, arr)

    # ---- 1. a field operator; domains shrink by the read extents ---- #
    @gtx.field_operator
    def lap(a: F) -> F:
        return a(Ioff[1]) + a(Ioff[-1]) + a(Joff[1]) + a(Joff[-1]) - 4.0 * a

    a = fld(-2, 2, -2, 2)
    r = lap(a)  # embedded execution follows the arguments' namespace
    assert r.domain[I].start == -1 and r.domain[I].stop == n + 1
    print("1. lap domain:", [(d.value, (rr.start, rr.stop)) for d, rr in r.domain])

    # ---- 2. backends: oracle vs compiled kernels ---- #
    ref = lap.with_backend(backends.numpy_oracle)(a)
    cur = pallas_bridge.FALLBACK_EVENTS.cursor()
    fast = lap.with_backend("pallas")(a)  # column kernel (or interpret)
    assert not pallas_bridge.FALLBACK_EVENTS.since(cur)
    np.testing.assert_allclose(fast.asnumpy(), ref.asnumpy(), rtol=1e-13)
    print("2. pallas == oracle, zero fallbacks")

    # ---- 3. a scan operator (column physics) ---- #
    @gtx.scan_operator(axis=K, forward=True, init=0.0)
    def damped_sum(carry: gtx.float64, x: gtx.float64) -> gtx.float64:
        return carry * 0.8 + x

    c_ref = damped_sum.with_backend(backends.numpy_oracle)(a)
    c_par = damped_sum.with_backend("pallas")(a)  # serial-K kernel
    np.testing.assert_allclose(c_par.asnumpy(), c_ref.asnumpy(), rtol=1e-13)
    print("3. scan operator: serial-K kernel == oracle")

    # ---- 4. concat_where: boundary conditions without out-of-bounds ---- #
    @gtx.field_operator
    def column_bc(t: F, sfc: F) -> F:
        interior = 0.5 * (t(Koff[-1]) + t)  # reads K-1: only legal for K >= 1
        return concat_where(K < 1, sfc * 1.0, interior)

    t, sfc = fld(0, 0, 0, 0), fld(0, 0, 0, 0)
    b_ref = column_bc.with_backend(backends.numpy_oracle)(t, sfc)
    b_par = column_bc.with_backend("pallas")(t, sfc)  # K-sectioned kernel
    np.testing.assert_allclose(b_par.asnumpy(), b_ref.asnumpy(), rtol=1e-13)
    print("4. concat_where: K-sectioned kernel == oracle")

    # ---- 5. a program; whole-program fusion on the pallas backend ---- #
    @gtx.field_operator
    def flux_limited(a: F, lp: F) -> F:
        fx = lp(Ioff[1]) - lp
        return where(fx * (a(Ioff[1]) - a) > 0.0, 0.0, fx)

    @gtx.field_operator
    def update(a: F, fx: F, coeff: gtx.float64) -> F:
        return a - coeff * (fx - fx(Ioff[-1]))

    @program
    def diffuse(a: F, lp: F, fx: F, out: F, coeff: gtx.float64):
        lap(a, out=lp)
        flux_limited(a, lp, out=fx)
        update(a, fx, coeff, out=out)

    def run(backend):
        args = [fld(-2, 2, -2, 2, 1), fld(-1, 1, -1, 1, 1), fld(-1, 0, 0, 0, 1), fld(0, 0, 0, 0, 1)]
        rng2 = np.random.default_rng(7)
        args[0] = gtx.Field(args[0].domain, rng2.random(args[0].data.shape))
        diffuse.with_backend(backend)(*args, 0.1)
        return args

    ref_args = run(backends.numpy_oracle)
    cur = pallas_bridge.FALLBACK_EVENTS.cursor()
    par_args = run("pallas")  # ONE fused kernel + thin halo strips
    assert not pallas_bridge.FALLBACK_EVENTS.since(cur)
    for nm, rr, pp in zip(("lap", "fx", "out"), ref_args[1:], par_args[1:]):
        np.testing.assert_allclose(pp.asnumpy(), rr.asnumpy(), rtol=1e-12, err_msg=nm)
    print("5. program fusion: every buffer (incl. halo-extended lap) == oracle")

    # ---- 6. autodiff through the compiled kernels ---- #
    import jax.numpy as jnp

    bound = lap.with_backend("pallas")
    a_j = gtx.Field(a.domain, jnp.asarray(a.data))

    def loss(x):
        return jnp.sum(bound(gtx.Field(a.domain, x)).data ** 2)

    g = jax.grad(loss)(jnp.asarray(a.data))
    print("6. grad through the kernel:", np.asarray(g).shape, "ok")

    print("\nquickstart complete")


if __name__ == "__main__":
    main()

"""Semi-Lagrangian transport: departure-point interpolation.

Departure points require data-dependent *horizontal* gathers, which the
Cartesian stencil DSL deliberately does not express (only K offsets may be
data-dependent); this model is therefore written directly against jax --
the formulation is a per-level bilinear gather, vectorized over
K, with periodic index wrapping.  (Workload named by BASELINE.json; absent
from the reference repository.)
"""

from typing import Tuple

import numpy as np


def semi_lagrangian_step(
    q, u, v, dt: float, dx: float = 1.0, dy: float = 1.0, *, max_shift=None
):
    """One semi-Lagrangian advection step (first-order trajectories,
    bilinear interpolation, periodic domain).

    Arrays are physical K-leading ``(K, NI, NJ)`` (no halo needed --
    periodicity is handled by index wrapping).  Returns the advected q.

    ``max_shift``: bound on the departure displacement in cells.  When
    given, the interpolation evaluates as a windowed sum of periodic
    rolls and pointwise selects -- pure VPU work.  When None, a general
    3D gather is used: exact for any displacement (production
    configurations bound CFL anyway).
    """
    import jax.numpy as jnp

    if max_shift is not None:
        return _windowed_step(q, u, v, dt, dx, dy, int(max_shift))

    nk, ni, nj = q.shape
    # arrival-grid index coordinates
    ii = jnp.arange(ni, dtype=q.dtype).reshape(1, ni, 1)
    jj = jnp.arange(nj, dtype=q.dtype).reshape(1, 1, nj)
    # departure points (in index space)
    xd = ii - u * (dt / dx)
    yd = jj - v * (dt / dy)

    i0 = jnp.floor(xd)
    j0 = jnp.floor(yd)
    wi = (xd - i0).astype(q.dtype)
    wj = (yd - j0).astype(q.dtype)
    i0 = i0.astype(jnp.int32) % ni
    j0 = j0.astype(jnp.int32) % nj
    i1 = (i0 + 1) % ni
    j1 = (j0 + 1) % nj

    kk = jnp.arange(nk, dtype=jnp.int32).reshape(nk, 1, 1)
    kk = jnp.broadcast_to(kk, (nk, ni, nj))

    def gather(iidx, jidx):
        return q[kk, jnp.broadcast_to(iidx, (nk, ni, nj)),
                 jnp.broadcast_to(jidx, (nk, ni, nj))]

    q00 = gather(i0, j0)
    q01 = gather(i0, j1)
    q10 = gather(i1, j0)
    q11 = gather(i1, j1)

    return (
        (1 - wi) * (1 - wj) * q00
        + (1 - wi) * wj * q01
        + wi * (1 - wj) * q10
        + wi * wj * q11
    )


def _windowed_step(q, u, v, dt: float, dx: float, dy: float, W: int):
    """Bounded-displacement formulation: the bilinear corners land within
    ``W`` cells of the arrival point, so the gather becomes a sum over
    the (2W+2)^2 periodic rolls weighted by pointwise corner-match masks.
    Bitwise-equal to the gather path for in-bound displacements (the
    nonzero terms accumulate in the same order with identical products);
    out-of-bound displacements clamp to the window edge."""
    import jax.numpy as jnp

    nk, ni, nj = q.shape
    ii = jnp.arange(ni, dtype=q.dtype).reshape(1, ni, 1)
    jj = jnp.arange(nj, dtype=q.dtype).reshape(1, 1, nj)
    xd = ii - u * (dt / dx)
    yd = jj - v * (dt / dy)
    i0f = jnp.floor(xd)
    j0f = jnp.floor(yd)
    wi = (xd - i0f).astype(q.dtype)
    wj = (yd - j0f).astype(q.dtype)
    # wrapped displacement of the low corner, clamped into the window
    half_i, half_j = ni // 2, nj // 2
    di = (i0f.astype(jnp.int32) - ii.astype(jnp.int32) + half_i) % ni - half_i
    dj = (j0f.astype(jnp.int32) - jj.astype(jnp.int32) + half_j) % nj - half_j
    di = jnp.clip(di, -W, W)
    dj = jnp.clip(dj, -W, W)

    zero = jnp.zeros_like(q)
    acc = zero
    for d_i in range(-W, W + 2):
        # weight of I-shift d_i: low corner when di == d_i, high when
        # di == d_i - 1 (the corner above the low one)
        wiw = jnp.where(di == d_i, 1.0 - wi, zero) + jnp.where(
            di == d_i - 1, wi, zero
        )
        qi = jnp.roll(q, -d_i, axis=1)
        for d_j in range(-W, W + 2):
            wjw = jnp.where(dj == d_j, 1.0 - wj, zero) + jnp.where(
                dj == d_j - 1, wj, zero
            )
            acc = acc + wiw * wjw * jnp.roll(qi, -d_j, axis=2)
    return acc


def make_sl_stencil(dtype, backend="jax", max_shift: int = 1):
    """The windowed semi-Lagrangian step as a GTScript STENCIL: every
    corner lies at a fixed offset, so the gather is (2W+2)^2 ternary-
    weighted neighbor reads -- which the pallas backend fuses into ONE
    tile kernel with periodic wrap in the DMA (vs ~(2W+2)^2 full-array
    XLA passes for the jnp roll/select form, ~8x the HBM traffic).

    ``floor(i + s) == i + floor(s)`` for exact integer i, so the
    displacement splits per point without any index arithmetic:
    ``di = floor(-u*dt/dx)``, ``wi`` the fractional part.  Signature:
    ``sl(q, u, v, qout, dtdx=dt/dx, dtdy=dt/dy)``.
    """
    import linecache
    import textwrap

    from gt4py_tpu.cartesian import gtscript

    W = int(max_shift)
    Field = gtscript.Field[dtype]

    def wterm(axis, a):
        w = "wi" if axis == "i" else "wj"
        d = "di" if axis == "i" else "dj"
        return (
            f"(((1.0 - {w}) if {d} == {float(a)} else 0.0)"
            f" + ({w} if {d} == {float(a - 1)} else 0.0))"
        )

    terms = []
    for a in range(-W, W + 2):
        for b in range(-W, W + 2):
            terms.append(f"({wterm('i', a)} * {wterm('j', b)}) * q[{a}, {b}, 0]")
    body = " + ".join(terms)
    src = textwrap.dedent(
        f"""
        def sl_step(q: Field, u: Field, v: Field, qout: Field, *,
                    dtdx: dtype, dtdy: dtype):
            with computation(PARALLEL), interval(...):
                s = -u * dtdx
                t = -v * dtdy
                dif = floor(s)
                djf = floor(t)
                wi = s - dif
                wj = t - djf
                di = min(max(dif, {float(-W)}), {float(W)})
                dj = min(max(djf, {float(-W)}), {float(W)})
                qout = {body}
        """
    )
    filename = f"<sl-stencil-W{W}-{np.dtype(dtype).name}>"
    linecache.cache[filename] = (len(src), None, src.splitlines(True), filename)
    ns = {
        "Field": Field,
        "dtype": dtype,
        "computation": gtscript.computation,
        "interval": gtscript.interval,
        "PARALLEL": gtscript.PARALLEL,
        "floor": gtscript.floor,
        "min": min,
        "max": max,
    }
    exec(compile(src, filename, "exec"), ns)
    return gtscript.stencil(
        backend=backend,
        definition=ns["sl_step"],
        name=f"sl_step_w{W}_{np.dtype(dtype).name}",
        literal_precision=32 if np.dtype(dtype).itemsize <= 4 else 64,
    )


def semi_lagrangian_step_numpy(q, u, v, dt: float, dx: float = 1.0, dy: float = 1.0):
    """NumPy oracle with identical semantics."""
    nk, ni, nj = q.shape
    ii = np.arange(ni, dtype=q.dtype).reshape(1, ni, 1)
    jj = np.arange(nj, dtype=q.dtype).reshape(1, 1, nj)
    xd = ii - u * (dt / dx)
    yd = jj - v * (dt / dy)
    i0 = np.floor(xd)
    j0 = np.floor(yd)
    wi = (xd - i0).astype(q.dtype)
    wj = (yd - j0).astype(q.dtype)
    i0 = i0.astype(np.int64) % ni
    j0 = j0.astype(np.int64) % nj
    i1 = (i0 + 1) % ni
    j1 = (j0 + 1) % nj
    kk = np.broadcast_to(np.arange(nk).reshape(nk, 1, 1), (nk, ni, nj))
    i0b = np.broadcast_to(i0, (nk, ni, nj))
    j0b = np.broadcast_to(j0, (nk, ni, nj))
    i1b = np.broadcast_to(i1, (nk, ni, nj))
    j1b = np.broadcast_to(j1, (nk, ni, nj))
    q00 = q[kk, i0b, j0b]
    q01 = q[kk, i0b, j1b]
    q10 = q[kk, i1b, j0b]
    q11 = q[kk, i1b, j1b]
    return (
        (1 - wi) * (1 - wj) * q00
        + (1 - wi) * wj * q01
        + wi * (1 - wj) * q10
        + wi * wj * q11
    )

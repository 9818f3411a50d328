"""Rotating shallow-water equations on an Arakawa C-grid.

Linear multi-layer SWE (every K level is an independent layer) with a
forward-backward time scheme: momentum advances with the current height
gradient, continuity with the *updated* winds — the classic
mass-conserving core of barotropic solvers.  Like FVTP2D this workload
is not in the reference repository (it lives in the models built on
GT4Py); it is authored natively in the GTScript DSL with the numpy
backend as its oracle.

Staggering (C-grid): ``h`` at cell centers, ``u`` at x-faces (index i is
the face between cells i-1 and i), ``v`` at y-faces.  The whole step is
ONE stencil — the provisional winds are in-stencil temporaries, and the
continuity update reads them at offsets (whole-domain parallel-assignment semantics).

Mass is conserved exactly (flux form + periodic boundaries): the height
update telescopes under the periodic sum.
"""

from typing import Dict, Tuple

import numpy as np

from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import PARALLEL, computation, interval

from .dycore import _literal_precision


def make_sw_step(dtype, backend="jax", *, g=9.81, H=100.0, f=1e-4,
                 dx=1e4, dy=1e4, dt=10.0):
    """Forward-backward C-grid step: u,v advance with the old height
    gradient (+ Coriolis on the 4-point averaged transverse wind), h with
    the divergence of the NEW winds (in-stencil temporaries)."""
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"sw_step_{np.dtype(dtype).name}",
        externals={
            "G_DTDX": g * dt / dx,
            "G_DTDY": g * dt / dy,
            "H_DTDX": H * dt / dx,
            "H_DTDY": H * dt / dy,
            "F_DT": f * dt,
        },
        literal_precision=_literal_precision(dtype),
    )
    def sw_step(
        h: Field,
        u: Field,
        v: Field,
        h_new: Field,
        u_new: Field,
        v_new: Field,
    ):
        from __externals__ import F_DT, G_DTDX, G_DTDY, H_DTDX, H_DTDY

        with computation(PARALLEL), interval(...):
            # transverse winds averaged to the opposite staggering points
            vbar = 0.25 * (v[-1, 0, 0] + v[0, 0, 0] + v[-1, 1, 0] + v[0, 1, 0])
            ubar = 0.25 * (u[0, -1, 0] + u[1, -1, 0] + u[0, 0, 0] + u[1, 0, 0])
            # provisional winds (temporaries: read at offsets below)
            ut = u[0, 0, 0] + F_DT * vbar - G_DTDX * (h[0, 0, 0] - h[-1, 0, 0])
            vt = v[0, 0, 0] - F_DT * ubar - G_DTDY * (h[0, 0, 0] - h[0, -1, 0])
            # continuity with the updated winds (forward-backward)
            h_new = (
                h[0, 0, 0]
                - H_DTDX * (ut[1, 0, 0] - ut[0, 0, 0])
                - H_DTDY * (vt[0, 1, 0] - vt[0, 0, 0])
            )
            u_new = ut[0, 0, 0]
            v_new = vt[0, 0, 0]

    return sw_step


class ShallowWater:
    """Multi-layer linear rotating SWE, periodic, one fused kernel/step.

    ``step(h, u, v) -> (h, u, v)`` on physical K-leading buffers;
    K levels are independent layers (vectorized batch dimension).
    """

    HALO = 2

    def __init__(
        self,
        ni: int,
        nj: int,
        nk: int,
        *,
        dtype=np.float32,
        backend="jax",
        g=9.81,
        H=100.0,
        f=1e-4,
        dx=1e4,
        dy=1e4,
        dt=10.0,
    ):
        self.ni, self.nj, self.nk = ni, nj, nk
        self.dtype = np.dtype(dtype)
        self.backend = backend
        self.params = dict(g=g, H=H, f=f, dx=dx, dy=dy, dt=dt)
        h = self.HALO
        self.oi = self.oj = h
        self.stencil = make_sw_step(dtype, backend, **self.params)
        physical = backend in ("jax", "pallas")
        if physical:
            kw = dict(
                origin=(self.oi, self.oj, 0),
                domain=(ni, nj, nk),
                physical_layout=True,
            )
            self.fn = self.stencil.functional(**kw)
            self.fn_p = self.stencil.functional(**kw, periodic=("I", "J"))

    def field_shape(self) -> Tuple[int, int, int]:
        h = self.HALO
        return (self.nk, self.ni + 2 * h, self.nj + 2 * h)

    def init_state(self, seed: int = 0) -> Dict[str, np.ndarray]:
        """A Gaussian height anomaly per layer; winds at rest."""
        shape = self.field_shape()
        _, pni, pnj = shape
        ii = np.arange(pni)[None, :, None] - self.oi
        jj = np.arange(pnj)[None, None, :] - self.oj
        ci, cj = self.ni / 2, self.nj / 2
        r2 = ((ii - ci) / (self.ni / 8)) ** 2 + ((jj - cj) / (self.nj / 8)) ** 2
        bump = np.exp(-r2)
        amp = 1.0 + 0.1 * np.arange(1, self.nk + 1)[:, None, None] / self.nk
        return {
            "h": (amp * bump).astype(self.dtype),
            "u": np.zeros(shape, self.dtype),
            "v": np.zeros(shape, self.dtype),
        }

    # ------------------------------------------------------------------ #

    def step_fn(self):
        """Pure jax step with periodic boundaries folded into the
        kernels' tile DMA (no fill passes)."""
        fn = self.fn_p

        def step(h, u, v):
            import jax.numpy as jnp

            z = jnp.zeros_like(h)
            outs = fn(h=h, u=u, v=v, h_new=z, u_new=z, v_new=z)
            return outs["h_new"], outs["u_new"], outs["v_new"]

        return step

    def local_step_fn(self):
        """Non-periodic step on halo-prefilled blocks (the shard_map /
        halo-exchange path)."""
        fn = self.fn

        def step(h, u, v):
            import jax.numpy as jnp

            z = jnp.zeros_like(h)
            outs = fn(h=h, u=u, v=v, h_new=z, u_new=z, v_new=z)
            return outs["h_new"], outs["u_new"], outs["v_new"]

        return step

    # ------------------------------------------------------------------ #

    def run_numpy_oracle(self, h, u, v):
        """Reference-semantics step on logical (I, J, K) numpy arrays
        (fills halos, runs the same stencil through the numpy backend)."""
        assert self.backend == "numpy"
        hw, ni, nj, nk = self.HALO, self.ni, self.nj, self.nk
        origin = (hw, hw, 0)
        dom = (ni, nj, nk)

        def fill(a):
            a[:hw] = a[ni : ni + hw]
            a[hw + ni : 2 * hw + ni] = a[hw : 2 * hw]
            a[:, :hw] = a[:, nj : nj + hw]
            a[:, hw + nj : 2 * hw + nj] = a[:, hw : 2 * hw]
            return a

        h, u, v = fill(h.copy()), fill(u.copy()), fill(v.copy())
        hn = np.zeros_like(h)
        un = np.zeros_like(u)
        vn = np.zeros_like(v)
        self.stencil(h, u, v, hn, un, vn, origin=origin, domain=dom)
        return hn, un, vn

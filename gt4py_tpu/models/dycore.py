"""Mini dynamical core: horizontal diffusion + vertical advection.

The stencil definitions follow the reference's canonical workloads
(reference: tests/cartesian_tests/integration_tests/multi_feature_tests/
stencil_definitions.py:317-330 horizontal_diffusion and :236-315
vertical_advection_dycore) -- re-authored here as model code, composed
functionally so a full timestep traces into ONE fused XLA program.

Distribution: the same local step runs inside ``shard_map`` with explicit
ppermute halo exchange (periodic boundaries), or on sharded global arrays
via GSPMD.
"""

# NOTE: no ``from __future__ import annotations`` here -- stencil parameter
# annotations must evaluate eagerly so closure-local Field descriptors
# (``Field = gtscript.Field[dtype]`` inside factory functions) resolve.

from typing import Dict, Optional, Tuple

import numpy as np

from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    computation,
    interval,
)


def _literal_precision(dtype) -> int:
    return 32 if np.dtype(dtype).itemsize <= 4 else 64


def make_hdiff(dtype, backend="jax"):
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"hdiff_{np.dtype(dtype).name}",
        literal_precision=_literal_precision(dtype),
    )
    def horizontal_diffusion(in_field: Field, out_field: Field, coeff: Field):
        with computation(PARALLEL), interval(...):
            lap_field = 4.0 * in_field[0, 0, 0] - (
                in_field[1, 0, 0] + in_field[-1, 0, 0]
                + in_field[0, 1, 0] + in_field[0, -1, 0]
            )
            res = lap_field[1, 0, 0] - lap_field[0, 0, 0]
            flx_field = 0 if (res * (in_field[1, 0, 0] - in_field[0, 0, 0])) > 0 else res
            res = lap_field[0, 1, 0] - lap_field[0, 0, 0]
            fly_field = 0 if (res * (in_field[0, 1, 0] - in_field[0, 0, 0])) > 0 else res
            out_field = in_field[0, 0, 0] - coeff[0, 0, 0] * (
                flx_field[0, 0, 0] - flx_field[-1, 0, 0]
                + fly_field[0, 0, 0] - fly_field[0, -1, 0]
            )

    return horizontal_diffusion


def make_vadv(dtype, backend="jax", *, bet_m=0.5, bet_p=0.5):
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"vadv_{np.dtype(dtype).name}",
        externals={"BET_M": bet_m, "BET_P": bet_p},
        literal_precision=_literal_precision(dtype),
    )
    def vertical_advection_dycore(
        utens_stage: Field,
        u_stage: Field,
        wcon: Field,
        u_pos: Field,
        utens: Field,
        *,
        dtr_stage: dtype,  # stencil-precision scalar: a bare ``float``
        # annotation would make it f64 and C-promote the whole
        # tridiagonal temp chain to f64
    ):
        from __externals__ import BET_M, BET_P

        with computation(FORWARD):
            with interval(0, 1):
                gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])
                cs = gcv * BET_M
                ccol = gcv * BET_P
                bcol = dtr_stage - ccol[0, 0, 0]
                correction_term = -cs * (u_stage[0, 0, 1] - u_stage[0, 0, 0])
                dcol = (
                    dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0]
                    + utens_stage[0, 0, 0] + correction_term
                )
                divided = 1.0 / bcol[0, 0, 0]
                ccol = ccol[0, 0, 0] * divided
                dcol = dcol[0, 0, 0] * divided
            with interval(1, -1):
                gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
                gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])
                as_ = gav * BET_M
                cs = gcv * BET_M
                acol = gav * BET_P
                ccol = gcv * BET_P
                bcol = dtr_stage - acol[0, 0, 0] - ccol[0, 0, 0]
                correction_term = -as_ * (u_stage[0, 0, -1] - u_stage[0, 0, 0]) - cs * (
                    u_stage[0, 0, 1] - u_stage[0, 0, 0]
                )
                dcol = (
                    dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0]
                    + utens_stage[0, 0, 0] + correction_term
                )
                divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
                ccol = ccol[0, 0, 0] * divided
                dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided
            with interval(-1, None):
                gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
                as_ = gav * BET_M
                acol = gav * BET_P
                bcol = dtr_stage - acol[0, 0, 0]
                correction_term = -as_ * (u_stage[0, 0, -1] - u_stage[0, 0, 0])
                dcol = (
                    dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0]
                    + utens_stage[0, 0, 0] + correction_term
                )
                divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
                dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided

        with computation(BACKWARD):
            with interval(-1, None):
                datacol = dcol[0, 0, 0]
                utens_stage = dtr_stage * (datacol - u_pos[0, 0, 0])
            with interval(0, -1):
                datacol = dcol[0, 0, 0] - ccol[0, 0, 0] * datacol[0, 0, 1]
                utens_stage = dtr_stage * (datacol - u_pos[0, 0, 0])

    return vertical_advection_dycore


def make_vadv_update(dtype, backend="jax", *, bet_m=0.5, bet_p=0.5):
    """vadv fused with the prognostic update ``u_out = u_pos + ts/dtr``:
    one extra in-kernel write replaces a whole-buffer XLA pass."""
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"vadv_upd_{np.dtype(dtype).name}",
        externals={"BET_M": bet_m, "BET_P": bet_p},
        literal_precision=_literal_precision(dtype),
    )
    def vertical_advection_update(
        utens_stage: Field,
        u_stage: Field,
        wcon: Field,
        u_pos: Field,
        utens: Field,
        u_out: Field,
        *,
        dtr_stage: dtype,
    ):
        from __externals__ import BET_M, BET_P

        with computation(FORWARD):
            with interval(0, 1):
                gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])
                cs = gcv * BET_M
                ccol = gcv * BET_P
                bcol = dtr_stage - ccol[0, 0, 0]
                correction_term = -cs * (u_stage[0, 0, 1] - u_stage[0, 0, 0])
                dcol = (
                    dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0]
                    + utens_stage[0, 0, 0] + correction_term
                )
                divided = 1.0 / bcol[0, 0, 0]
                ccol = ccol[0, 0, 0] * divided
                dcol = dcol[0, 0, 0] * divided
            with interval(1, -1):
                gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
                gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])
                as_ = gav * BET_M
                cs = gcv * BET_M
                acol = gav * BET_P
                ccol = gcv * BET_P
                bcol = dtr_stage - acol[0, 0, 0] - ccol[0, 0, 0]
                correction_term = -as_ * (u_stage[0, 0, -1] - u_stage[0, 0, 0]) - cs * (
                    u_stage[0, 0, 1] - u_stage[0, 0, 0]
                )
                dcol = (
                    dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0]
                    + utens_stage[0, 0, 0] + correction_term
                )
                divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
                ccol = ccol[0, 0, 0] * divided
                dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided
            with interval(-1, None):
                gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
                as_ = gav * BET_M
                acol = gav * BET_P
                bcol = dtr_stage - acol[0, 0, 0]
                correction_term = -as_ * (u_stage[0, 0, -1] - u_stage[0, 0, 0])
                dcol = (
                    dtr_stage * u_pos[0, 0, 0] + utens[0, 0, 0]
                    + utens_stage[0, 0, 0] + correction_term
                )
                divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
                dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided

        with computation(BACKWARD):
            with interval(-1, None):
                datacol = dcol[0, 0, 0]
                utens_stage = dtr_stage * (datacol - u_pos[0, 0, 0])
                u_out = u_pos[0, 0, 0] + utens_stage[0, 0, 0] * (1.0 / dtr_stage)
            with interval(0, -1):
                datacol = dcol[0, 0, 0] - ccol[0, 0, 0] * datacol[0, 0, 1]
                utens_stage = dtr_stage * (datacol - u_pos[0, 0, 0])
                u_out = u_pos[0, 0, 0] + utens_stage[0, 0, 0] * (1.0 / dtr_stage)

    return vertical_advection_update


def make_dycore_fused(dtype, backend="jax", *, bet_m=0.5, bet_p=0.5):
    """The WHOLE dycore step as ONE stencil: horizontal diffusion
    (PARALLEL) feeding the vertical-advection tridiagonal solve
    (FORWARD+BACKWARD) and the prognostic update -- the diffused stage
    becomes an in-kernel TEMPORARY instead of an HBM round trip, and
    ``u`` is read once instead of twice.  Named by the r5 SOL table
    (docs/performance.md): the 2-kernel step is traffic-bound at ~50%
    attained with 40 bytes/pt; this form models at 28 bytes/pt."""
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"dycore_fused_{np.dtype(dtype).name}",
        externals={"BET_M": bet_m, "BET_P": bet_p},
        literal_precision=_literal_precision(dtype),
    )
    def dycore_fused(
        u: Field,
        coeff: Field,
        wcon: Field,
        utens: Field,
        utens_stage: Field,
        u_out: Field,
        *,
        dtr_stage: dtype,
    ):
        from __externals__ import BET_M, BET_P

        with computation(PARALLEL), interval(...):
            lap_field = 4.0 * u[0, 0, 0] - (
                u[1, 0, 0] + u[-1, 0, 0] + u[0, 1, 0] + u[0, -1, 0]
            )
            res = lap_field[1, 0, 0] - lap_field[0, 0, 0]
            flx_field = 0 if (res * (u[1, 0, 0] - u[0, 0, 0])) > 0 else res
            res = lap_field[0, 1, 0] - lap_field[0, 0, 0]
            fly_field = 0 if (res * (u[0, 1, 0] - u[0, 0, 0])) > 0 else res
            u_stage = u[0, 0, 0] - coeff[0, 0, 0] * (
                flx_field[0, 0, 0] - flx_field[-1, 0, 0]
                + fly_field[0, 0, 0] - fly_field[0, -1, 0]
            )

        with computation(FORWARD):
            with interval(0, 1):
                gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])
                cs = gcv * BET_M
                ccol = gcv * BET_P
                bcol = dtr_stage - ccol[0, 0, 0]
                correction_term = -cs * (u_stage[0, 0, 1] - u_stage[0, 0, 0])
                dcol = (
                    dtr_stage * u_stage[0, 0, 0] + utens[0, 0, 0]
                    + utens_stage[0, 0, 0] + correction_term
                )
                divided = 1.0 / bcol[0, 0, 0]
                ccol = ccol[0, 0, 0] * divided
                dcol = dcol[0, 0, 0] * divided
            with interval(1, -1):
                gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
                gcv = 0.25 * (wcon[1, 0, 1] + wcon[0, 0, 1])
                as_ = gav * BET_M
                cs = gcv * BET_M
                acol = gav * BET_P
                ccol = gcv * BET_P
                bcol = dtr_stage - acol[0, 0, 0] - ccol[0, 0, 0]
                correction_term = -as_ * (
                    u_stage[0, 0, -1] - u_stage[0, 0, 0]
                ) - cs * (u_stage[0, 0, 1] - u_stage[0, 0, 0])
                dcol = (
                    dtr_stage * u_stage[0, 0, 0] + utens[0, 0, 0]
                    + utens_stage[0, 0, 0] + correction_term
                )
                divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
                ccol = ccol[0, 0, 0] * divided
                dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided
            with interval(-1, None):
                gav = -0.25 * (wcon[1, 0, 0] + wcon[0, 0, 0])
                as_ = gav * BET_M
                acol = gav * BET_P
                bcol = dtr_stage - acol[0, 0, 0]
                correction_term = -as_ * (u_stage[0, 0, -1] - u_stage[0, 0, 0])
                dcol = (
                    dtr_stage * u_stage[0, 0, 0] + utens[0, 0, 0]
                    + utens_stage[0, 0, 0] + correction_term
                )
                divided = 1.0 / (bcol[0, 0, 0] - ccol[0, 0, -1] * acol[0, 0, 0])
                dcol = (dcol[0, 0, 0] - (dcol[0, 0, -1]) * acol[0, 0, 0]) * divided

        with computation(BACKWARD):
            with interval(-1, None):
                datacol = dcol[0, 0, 0]
                utens_stage = dtr_stage * (datacol - u_stage[0, 0, 0])
                u_out = u_stage[0, 0, 0] + utens_stage[0, 0, 0] * (1.0 / dtr_stage)
            with interval(0, -1):
                datacol = dcol[0, 0, 0] - ccol[0, 0, 0] * datacol[0, 0, 1]
                utens_stage = dtr_stage * (datacol - u_stage[0, 0, 0])
                u_out = u_stage[0, 0, 0] + utens_stage[0, 0, 0] * (1.0 / dtr_stage)

    return dycore_fused


def periodic_fill(arr, h: int, ni: int, nj: int, oi: int = None, oj: int = None):
    """Fill I/J halos (width h) of a physical (K, I, J) array periodically
    (axes 1=I, 2=J).  ``ni``/``nj`` are the DOMAIN sizes and must be passed
    explicitly: buffers carry alignment padding, so they cannot be inferred
    from the shape.  ``oi``/``oj`` are the interior origins (default: the
    halo width ``h``, the legacy tight-packed layout)."""
    if h == 0:
        return arr
    oi = h if oi is None else oi
    oj = h if oj is None else oj
    arr = arr.at[:, oi - h : oi].set(arr[:, oi + ni - h : oi + ni])
    arr = arr.at[:, oi + ni : oi + ni + h].set(arr[:, oi : oi + h])
    arr = arr.at[:, :, oj - h : oj].set(arr[:, :, oj + nj - h : oj + nj])
    arr = arr.at[:, :, oj + nj : oj + nj + h].set(arr[:, :, oj : oj + h])
    return arr


class MiniDycore:
    """A mini timestep: periodic-halo hdiff + vertical advection + update.

    ``step_fn(fill_halos=True)`` returns a pure jax function
    ``step(state) -> state`` over a dict of halo-extended field arrays;
    the entire step traces into one fused XLA program.  With
    ``fill_halos=False`` halos are assumed pre-filled (the shard_map halo
    exchange path).
    """

    HALO = 3

    def __init__(
        self,
        ni: int,
        nj: int,
        nk: int,
        *,
        dtype=np.float32,
        backend="jax",
    ):
        self.ni, self.nj, self.nk = ni, nj, nk
        self.dtype = np.dtype(dtype)
        h = self.HALO
        # interiors packed tight at origin (h, h): no padding for alignment
        # (the column kernel masks ragged blocks; coalescing follows J)
        self.oi = self.oj = h
        self.hdiff = make_hdiff(dtype, backend)
        self.vadv = make_vadv(dtype, backend)
        self.vadv_upd = make_vadv_update(dtype, backend)
        # physical K-leading layout end-to-end: zero transposes per step
        kw = dict(
            origin=(self.oi, self.oj, 0),
            domain=(ni, nj, nk),
            physical_layout=True,
        )
        self.hdiff_fn = self.hdiff.functional(**kw)
        self.vadv_fn = self.vadv.functional(**kw)
        self.vadv_upd_fn = self.vadv_upd.functional(**kw)
        # periodic-boundary variants: the halo wrap happens inside the
        # stencil call -- the step then needs no explicit fill passes
        self.hdiff_fn_p = self.hdiff.functional(**kw, periodic=("I", "J"))
        self.vadv_upd_fn_p = self.vadv_upd.functional(**kw, periodic=("I", "J"))
        # single-stencil form: diffusion feeds the tridiagonal solve
        # through a temporary -- 28 bytes/pt vs 40
        self.fused = make_dycore_fused(dtype, backend)
        self.fused_fn = self.fused.functional(**kw)
        self.fused_fn_p = self.fused.functional(**kw, periodic=("I", "J"))

    def field_shape(self) -> Tuple[int, int, int]:
        """Physical (K, I, J) buffer shape."""
        h = self.HALO
        return (self.nk, self.ni + 2 * h, self.nj + 2 * h)

    def init_state(self, seed: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(seed)
        shape = self.field_shape()
        dt = self.dtype
        return {
            "u": rng.random(shape).astype(dt),
            "coeff": (0.025 * rng.random(shape)).astype(dt),
            "wcon": (0.2 * rng.random(shape)).astype(dt),
            "utens": (0.01 * rng.random(shape)).astype(dt),
            "utens_stage": rng.random(shape).astype(dt),
        }

    #: fields actually read at horizontal offsets (hdiff in_field at
    #: +-2, vadv wcon at i+1) -- the only ones whose halos a step needs
    FILL_FIELDS = ("u", "wcon")

    def step_fn(self, *, fill_halos: bool = True, dtr_stage: float = 3.0,
                fused: bool = False):
        """``fill_halos=True``: periodic boundaries, handled as a stencil
        execution option (reads wrap in the kernels' tile DMA -- no fill
        passes).  ``fill_halos=False``: halos assumed pre-filled by the
        shard_map halo exchange; plain stencils.  ``fused=True``: the
        whole step as ONE kernel (make_dycore_fused)."""
        if fused:
            fn = self.fused_fn_p if fill_halos else self.fused_fn

            def step(state: Dict) -> Dict:
                import jax.numpy as jnp

                outs = fn(
                    u=state["u"],
                    coeff=state["coeff"],
                    wcon=state["wcon"],
                    utens=state["utens"],
                    utens_stage=state["utens_stage"],
                    u_out=state["u"],
                    dtr_stage=jnp.asarray(dtr_stage, dtype=self.dtype),
                )
                new_state = dict(state)
                new_state["u"] = outs["u_out"]
                new_state["utens_stage"] = outs["utens_stage"]
                return new_state

            return step
        hdiff_fn = self.hdiff_fn_p if fill_halos else self.hdiff_fn
        vadv_upd_fn = self.vadv_upd_fn_p if fill_halos else self.vadv_upd_fn
        return self._make_step(hdiff_fn, vadv_upd_fn, dtr_stage)

    def region_step_factory(self, *, dtr_stage: float = 3.0):
        """``make((oi, oj), (di, dj)) -> step(**fields) -> dict`` computing
        only the given sub-region (halo-extended local coordinates) -- the
        region interface ``overlapped_shard_map_stencil`` splits a shard's
        step into a halo-independent interior and halo-dependent boundary
        strips.  vadv reads its chained input ``u_stage`` only at K
        offsets, so the hdiff/vadv regions coincide exactly."""

        def make(origin_ij, domain_ij):
            oi, oj = origin_ij
            di, dj = domain_ij
            kw = dict(
                origin=(oi, oj, 0),
                domain=(di, dj, self.nk),
                physical_layout=True,
            )
            hdiff_fn = self.hdiff.functional(**kw)
            vadv_upd_fn = self.vadv_upd.functional(**kw)
            step = self._make_step(hdiff_fn, vadv_upd_fn, dtr_stage)

            def region_step(**fields):
                return step(dict(fields))

            return region_step

        return make

    def _make_step(self, hdiff_fn, vadv_upd_fn, dtr_stage: float):

        def step(state: Dict) -> Dict:
            import jax.numpy as jnp

            u = state["u"]
            diffused = hdiff_fn(
                in_field=u, out_field=u, coeff=state["coeff"]
            )["out_field"]
            # vadv fused with the prognostic update: utens_stage and
            # u_out = diffused + (1/dtr)*utens_stage in one kernel (the
            # separate XLA update pass cost a full-state HBM round trip)
            outs = vadv_upd_fn(
                utens_stage=state["utens_stage"],
                u_stage=diffused,
                wcon=state["wcon"],
                u_pos=diffused,
                utens=state["utens"],
                u_out=u,
                dtr_stage=jnp.asarray(dtr_stage, dtype=self.dtype),
            )
            new_state = dict(state)
            new_state["u"] = outs["u_out"]
            new_state["utens_stage"] = outs["utens_stage"]
            return new_state

        return step

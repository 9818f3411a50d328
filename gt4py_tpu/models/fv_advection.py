"""FVTP2D-style finite-volume advection with monotone PPM flux limiters.

Two-dimensional flux-form transport following Lin & Rood (1996) inner/outer
operator splitting with PPM (piecewise parabolic) reconstruction and the
Colella-Woodward monotonicity limiter.  This workload is *not present in the
reference repository* -- it lives in FV3/Pace dycores built on GT4Py
(SURVEY.md §6) -- so it is authored here natively in the GTScript DSL, with
the numpy backend as its correctness oracle.

All stencils are PARALLEL (per-level), written in GTScript with relative
offsets; monotone limiting uses pointwise ternaries.  Periodic boundaries
via halo filling between stages.
"""

# NOTE: annotations must evaluate eagerly (closure-local Field descriptors).

from typing import Dict, Tuple

import numpy as np

from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import PARALLEL, computation, interval

from .dycore import _literal_precision, periodic_fill


def make_xflux(dtype, backend="jax"):
    """PPM flux in I: ``flux[i]`` is the transport through face i
    (between cells i-1 and i), given the face Courant number ``cx``."""
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"ppm_xflux_{np.dtype(dtype).name}",
        literal_precision=_literal_precision(dtype),
    )
    def xflux(q: Field, cx: Field, flux: Field):
        with computation(PARALLEL), interval(...):
            # 4th-order edge interpolation: al at face i (left edge of cell i)
            al = 7.0 / 12.0 * (q[-1, 0, 0] + q[0, 0, 0]) - 1.0 / 12.0 * (
                q[-2, 0, 0] + q[1, 0, 0]
            )
            # edge deviations of cell i
            bl = al[0, 0, 0] - q[0, 0, 0]
            br = al[1, 0, 0] - q[0, 0, 0]
            # Colella-Woodward monotone limiter
            dm = br - bl
            a6 = -3.0 * (bl + br)
            smooth = bl * br < 0.0
            blm = (-2.0 * br if dm * a6 > dm * dm else bl) if smooth else 0.0
            brm = (-2.0 * bl if dm * a6 < -dm * dm else br) if smooth else 0.0
            dml = brm - blm
            a6l = -3.0 * (blm + brm)
            # PPM flux integral through face i for both wind directions
            fpos = (q[-1, 0, 0] + brm[-1, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dml[-1, 0, 0] - a6l[-1, 0, 0] * (1.0 - 2.0 * cx[0, 0, 0] / 3.0)
            )
            fneg = (q[0, 0, 0] + blm[0, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dml[0, 0, 0] + a6l[0, 0, 0] * (1.0 + 2.0 * cx[0, 0, 0] / 3.0)
            )
            flux = cx[0, 0, 0] * (fpos if cx[0, 0, 0] >= 0.0 else fneg)

    return xflux


def make_yflux(dtype, backend="jax"):
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"ppm_yflux_{np.dtype(dtype).name}",
        literal_precision=_literal_precision(dtype),
    )
    def yflux(q: Field, cy: Field, flux: Field):
        with computation(PARALLEL), interval(...):
            al = 7.0 / 12.0 * (q[0, -1, 0] + q[0, 0, 0]) - 1.0 / 12.0 * (
                q[0, -2, 0] + q[0, 1, 0]
            )
            bl = al[0, 0, 0] - q[0, 0, 0]
            br = al[0, 1, 0] - q[0, 0, 0]
            dm = br - bl
            a6 = -3.0 * (bl + br)
            smooth = bl * br < 0.0
            blm = (-2.0 * br if dm * a6 > dm * dm else bl) if smooth else 0.0
            brm = (-2.0 * bl if dm * a6 < -dm * dm else br) if smooth else 0.0
            dml = brm - blm
            a6l = -3.0 * (blm + brm)
            fpos = (q[0, -1, 0] + brm[0, -1, 0]) - 0.5 * cy[0, 0, 0] * (
                dml[0, -1, 0] - a6l[0, -1, 0] * (1.0 - 2.0 * cy[0, 0, 0] / 3.0)
            )
            fneg = (q[0, 0, 0] + blm[0, 0, 0]) - 0.5 * cy[0, 0, 0] * (
                dml[0, 0, 0] + a6l[0, 0, 0] * (1.0 + 2.0 * cy[0, 0, 0] / 3.0)
            )
            flux = cy[0, 0, 0] * (fpos if cy[0, 0, 0] >= 0.0 else fneg)

    return yflux


def make_x_advect(dtype, backend="jax", factor=1.0):
    """Fused PPM x-flux + divergence update: the flux is an in-stencil
    temporary (recomputed per tile in the pallas backend; inlined/fused by
    XLA), removing the intermediate flux field's HBM round trip and its
    halo fill.  Bitwise-equal to xflux -> fill -> update_x because q's
    periodic halo (width 3) covers the fused extent exactly."""
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"fv_xadv_{np.dtype(dtype).name}_{factor}",
        externals={"FACTOR": factor},
        literal_precision=_literal_precision(dtype),
    )
    def x_advect(q: Field, cx: Field, qout: Field):
        from __externals__ import FACTOR

        with computation(PARALLEL), interval(...):
            al = 7.0 / 12.0 * (q[-1, 0, 0] + q[0, 0, 0]) - 1.0 / 12.0 * (
                q[-2, 0, 0] + q[1, 0, 0]
            )
            bl = al[0, 0, 0] - q[0, 0, 0]
            br = al[1, 0, 0] - q[0, 0, 0]
            dm = br - bl
            a6 = -3.0 * (bl + br)
            smooth = bl * br < 0.0
            blm = (-2.0 * br if dm * a6 > dm * dm else bl) if smooth else 0.0
            brm = (-2.0 * bl if dm * a6 < -dm * dm else br) if smooth else 0.0
            dml = brm - blm
            a6l = -3.0 * (blm + brm)
            fpos = (q[-1, 0, 0] + brm[-1, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dml[-1, 0, 0] - a6l[-1, 0, 0] * (1.0 - 2.0 * cx[0, 0, 0] / 3.0)
            )
            fneg = (q[0, 0, 0] + blm[0, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dml[0, 0, 0] + a6l[0, 0, 0] * (1.0 + 2.0 * cx[0, 0, 0] / 3.0)
            )
            flux = cx[0, 0, 0] * (fpos if cx[0, 0, 0] >= 0.0 else fneg)
            qout = q[0, 0, 0] - FACTOR * (flux[1, 0, 0] - flux[0, 0, 0])

    return x_advect


def make_y_advect(dtype, backend="jax", factor=1.0):
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"fv_yadv_{np.dtype(dtype).name}_{factor}",
        externals={"FACTOR": factor},
        literal_precision=_literal_precision(dtype),
    )
    def y_advect(q: Field, cy: Field, qout: Field):
        from __externals__ import FACTOR

        with computation(PARALLEL), interval(...):
            al = 7.0 / 12.0 * (q[0, -1, 0] + q[0, 0, 0]) - 1.0 / 12.0 * (
                q[0, -2, 0] + q[0, 1, 0]
            )
            bl = al[0, 0, 0] - q[0, 0, 0]
            br = al[0, 1, 0] - q[0, 0, 0]
            dm = br - bl
            a6 = -3.0 * (bl + br)
            smooth = bl * br < 0.0
            blm = (-2.0 * br if dm * a6 > dm * dm else bl) if smooth else 0.0
            brm = (-2.0 * bl if dm * a6 < -dm * dm else br) if smooth else 0.0
            dml = brm - blm
            a6l = -3.0 * (blm + brm)
            fpos = (q[0, -1, 0] + brm[0, -1, 0]) - 0.5 * cy[0, 0, 0] * (
                dml[0, -1, 0] - a6l[0, -1, 0] * (1.0 - 2.0 * cy[0, 0, 0] / 3.0)
            )
            fneg = (q[0, 0, 0] + blm[0, 0, 0]) - 0.5 * cy[0, 0, 0] * (
                dml[0, 0, 0] + a6l[0, 0, 0] * (1.0 + 2.0 * cy[0, 0, 0] / 3.0)
            )
            flux = cy[0, 0, 0] * (fpos if cy[0, 0, 0] >= 0.0 else fneg)
            qout = q[0, 0, 0] - FACTOR * (flux[0, 1, 0] - flux[0, 0, 0])

    return y_advect


def make_xy_advect(dtype, backend="jax", factor=1.0):
    """Both inner half-advections in ONE stencil (two outputs): qx and qy
    share the read of q, saving a full-buffer HBM pass vs separate
    x_advect + y_advect kernels.  Bitwise-equal: each output's expression
    chain is identical to its single-direction stencil."""
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"fv_xyadv_{np.dtype(dtype).name}_{factor}",
        externals={"FACTOR": factor},
        literal_precision=_literal_precision(dtype),
    )
    def xy_advect(q: Field, cx: Field, cy: Field, qx: Field, qy: Field):
        from __externals__ import FACTOR

        with computation(PARALLEL), interval(...):
            # x half-advection -> qx
            alx = 7.0 / 12.0 * (q[-1, 0, 0] + q[0, 0, 0]) - 1.0 / 12.0 * (
                q[-2, 0, 0] + q[1, 0, 0]
            )
            blx = alx[0, 0, 0] - q[0, 0, 0]
            brx = alx[1, 0, 0] - q[0, 0, 0]
            dmx = brx - blx
            a6x = -3.0 * (blx + brx)
            smx = blx * brx < 0.0
            blmx = (-2.0 * brx if dmx * a6x > dmx * dmx else blx) if smx else 0.0
            brmx = (-2.0 * blx if dmx * a6x < -dmx * dmx else brx) if smx else 0.0
            dmlx = brmx - blmx
            a6lx = -3.0 * (blmx + brmx)
            fposx = (q[-1, 0, 0] + brmx[-1, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dmlx[-1, 0, 0] - a6lx[-1, 0, 0] * (1.0 - 2.0 * cx[0, 0, 0] / 3.0)
            )
            fnegx = (q[0, 0, 0] + blmx[0, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dmlx[0, 0, 0] + a6lx[0, 0, 0] * (1.0 + 2.0 * cx[0, 0, 0] / 3.0)
            )
            fluxx = cx[0, 0, 0] * (fposx if cx[0, 0, 0] >= 0.0 else fnegx)
            qx = q[0, 0, 0] - FACTOR * (fluxx[1, 0, 0] - fluxx[0, 0, 0])
            # y half-advection -> qy
            aly = 7.0 / 12.0 * (q[0, -1, 0] + q[0, 0, 0]) - 1.0 / 12.0 * (
                q[0, -2, 0] + q[0, 1, 0]
            )
            bly = aly[0, 0, 0] - q[0, 0, 0]
            bry = aly[0, 1, 0] - q[0, 0, 0]
            dmy = bry - bly
            a6y = -3.0 * (bly + bry)
            smy = bly * bry < 0.0
            blmy = (-2.0 * bry if dmy * a6y > dmy * dmy else bly) if smy else 0.0
            brmy = (-2.0 * bly if dmy * a6y < -dmy * dmy else bry) if smy else 0.0
            dmly = brmy - blmy
            a6ly = -3.0 * (blmy + brmy)
            fposy = (q[0, -1, 0] + brmy[0, -1, 0]) - 0.5 * cy[0, 0, 0] * (
                dmly[0, -1, 0] - a6ly[0, -1, 0] * (1.0 - 2.0 * cy[0, 0, 0] / 3.0)
            )
            fnegy = (q[0, 0, 0] + blmy[0, 0, 0]) - 0.5 * cy[0, 0, 0] * (
                dmly[0, 0, 0] + a6ly[0, 0, 0] * (1.0 + 2.0 * cy[0, 0, 0] / 3.0)
            )
            fluxy = cy[0, 0, 0] * (fposy if cy[0, 0, 0] >= 0.0 else fnegy)
            qy = q[0, 0, 0] - FACTOR * (fluxy[0, 1, 0] - fluxy[0, 0, 0])

    return xy_advect


def make_fv_step(dtype, backend="jax"):
    """The ENTIRE Lin-Rood split step in ONE stencil: the cross-advected
    fields qx/qy and every PPM flux are in-stencil temporaries, recomputed
    in tile halos instead of round-tripping HBM.  Minimum possible traffic:
    read q, cx, cy; write qout (4 buffers vs 11 for the 2-kernel split).
    This is the form of the reference's on-the-fly stage merging
    (gtc/passes/oir_optimizations/horizontal_execution_merging.py:135):
    the extent analysis gives the temporaries their (+-3) halo extents."""
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"fv_step_{np.dtype(dtype).name}",
        literal_precision=_literal_precision(dtype),
    )
    def fv_step(q: Field, cx: Field, cy: Field, qout: Field):
        with computation(PARALLEL), interval(...):
            # inner x half-advection -> qx (temporary, j-extent +-3)
            alx = 7.0 / 12.0 * (q[-1, 0, 0] + q[0, 0, 0]) - 1.0 / 12.0 * (
                q[-2, 0, 0] + q[1, 0, 0]
            )
            blx = alx[0, 0, 0] - q[0, 0, 0]
            brx = alx[1, 0, 0] - q[0, 0, 0]
            dmx = brx - blx
            a6x = -3.0 * (blx + brx)
            smx = blx * brx < 0.0
            blmx = (-2.0 * brx if dmx * a6x > dmx * dmx else blx) if smx else 0.0
            brmx = (-2.0 * blx if dmx * a6x < -dmx * dmx else brx) if smx else 0.0
            dmlx = brmx - blmx
            a6lx = -3.0 * (blmx + brmx)
            fposx = (q[-1, 0, 0] + brmx[-1, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dmlx[-1, 0, 0] - a6lx[-1, 0, 0] * (1.0 - 2.0 * cx[0, 0, 0] / 3.0)
            )
            fnegx = (q[0, 0, 0] + blmx[0, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dmlx[0, 0, 0] + a6lx[0, 0, 0] * (1.0 + 2.0 * cx[0, 0, 0] / 3.0)
            )
            fluxx = cx[0, 0, 0] * (fposx if cx[0, 0, 0] >= 0.0 else fnegx)
            qx = q[0, 0, 0] - 0.5 * (fluxx[1, 0, 0] - fluxx[0, 0, 0])
            # inner y half-advection -> qy (temporary, i-extent +-3)
            aly = 7.0 / 12.0 * (q[0, -1, 0] + q[0, 0, 0]) - 1.0 / 12.0 * (
                q[0, -2, 0] + q[0, 1, 0]
            )
            bly = aly[0, 0, 0] - q[0, 0, 0]
            bry = aly[0, 1, 0] - q[0, 0, 0]
            dmy = bry - bly
            a6y = -3.0 * (bly + bry)
            smy = bly * bry < 0.0
            blmy = (-2.0 * bry if dmy * a6y > dmy * dmy else bly) if smy else 0.0
            brmy = (-2.0 * bly if dmy * a6y < -dmy * dmy else bry) if smy else 0.0
            dmly = brmy - blmy
            a6ly = -3.0 * (blmy + brmy)
            fposy = (q[0, -1, 0] + brmy[0, -1, 0]) - 0.5 * cy[0, 0, 0] * (
                dmly[0, -1, 0] - a6ly[0, -1, 0] * (1.0 - 2.0 * cy[0, 0, 0] / 3.0)
            )
            fnegy = (q[0, 0, 0] + blmy[0, 0, 0]) - 0.5 * cy[0, 0, 0] * (
                dmly[0, 0, 0] + a6ly[0, 0, 0] * (1.0 + 2.0 * cy[0, 0, 0] / 3.0)
            )
            fluxy = cy[0, 0, 0] * (fposy if cy[0, 0, 0] >= 0.0 else fnegy)
            qy = q[0, 0, 0] - 0.5 * (fluxy[0, 1, 0] - fluxy[0, 0, 0])
            # outer stage: x flux on qy
            alfx = 7.0 / 12.0 * (qy[-1, 0, 0] + qy[0, 0, 0]) - 1.0 / 12.0 * (
                qy[-2, 0, 0] + qy[1, 0, 0]
            )
            blfx = alfx[0, 0, 0] - qy[0, 0, 0]
            brfx = alfx[1, 0, 0] - qy[0, 0, 0]
            dmfx = brfx - blfx
            a6fx = -3.0 * (blfx + brfx)
            smfx = blfx * brfx < 0.0
            blmfx = (-2.0 * brfx if dmfx * a6fx > dmfx * dmfx else blfx) if smfx else 0.0
            brmfx = (-2.0 * blfx if dmfx * a6fx < -dmfx * dmfx else brfx) if smfx else 0.0
            dmlfx = brmfx - blmfx
            a6lfx = -3.0 * (blmfx + brmfx)
            fpfx = (qy[-1, 0, 0] + brmfx[-1, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dmlfx[-1, 0, 0] - a6lfx[-1, 0, 0] * (1.0 - 2.0 * cx[0, 0, 0] / 3.0)
            )
            fnfx = (qy[0, 0, 0] + blmfx[0, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dmlfx[0, 0, 0] + a6lfx[0, 0, 0] * (1.0 + 2.0 * cx[0, 0, 0] / 3.0)
            )
            fx = cx[0, 0, 0] * (fpfx if cx[0, 0, 0] >= 0.0 else fnfx)
            # outer stage: y flux on qx
            alfy = 7.0 / 12.0 * (qx[0, -1, 0] + qx[0, 0, 0]) - 1.0 / 12.0 * (
                qx[0, -2, 0] + qx[0, 1, 0]
            )
            blfy = alfy[0, 0, 0] - qx[0, 0, 0]
            brfy = alfy[0, 1, 0] - qx[0, 0, 0]
            dmfy = brfy - blfy
            a6fy = -3.0 * (blfy + brfy)
            smfy = blfy * brfy < 0.0
            blmfy = (-2.0 * brfy if dmfy * a6fy > dmfy * dmfy else blfy) if smfy else 0.0
            brmfy = (-2.0 * blfy if dmfy * a6fy < -dmfy * dmfy else brfy) if smfy else 0.0
            dmlfy = brmfy - blmfy
            a6lfy = -3.0 * (blmfy + brmfy)
            fpfy = (qx[0, -1, 0] + brmfy[0, -1, 0]) - 0.5 * cy[0, 0, 0] * (
                dmlfy[0, -1, 0] - a6lfy[0, -1, 0] * (1.0 - 2.0 * cy[0, 0, 0] / 3.0)
            )
            fnfy = (qx[0, 0, 0] + blmfy[0, 0, 0]) - 0.5 * cy[0, 0, 0] * (
                dmlfy[0, 0, 0] + a6lfy[0, 0, 0] * (1.0 + 2.0 * cy[0, 0, 0] / 3.0)
            )
            fy = cy[0, 0, 0] * (fpfy if cy[0, 0, 0] >= 0.0 else fnfy)
            qout = (
                q[0, 0, 0]
                - (fx[1, 0, 0] - fx[0, 0, 0])
                - (fy[0, 1, 0] - fy[0, 0, 0])
            )

    return fv_step


def make_fv_final(dtype, backend="jax"):
    """Fused outer stage: both outer PPM fluxes (on the cross-advected
    fields) plus the two divergence updates in one stencil."""
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"fv_final_{np.dtype(dtype).name}",
        literal_precision=_literal_precision(dtype),
    )
    def fv_final(q: Field, qx: Field, qy: Field, cx: Field, cy: Field, qout: Field):
        with computation(PARALLEL), interval(...):
            # x flux on qy
            alx = 7.0 / 12.0 * (qy[-1, 0, 0] + qy[0, 0, 0]) - 1.0 / 12.0 * (
                qy[-2, 0, 0] + qy[1, 0, 0]
            )
            blx = alx[0, 0, 0] - qy[0, 0, 0]
            brx = alx[1, 0, 0] - qy[0, 0, 0]
            dmx = brx - blx
            a6x = -3.0 * (blx + brx)
            smx = blx * brx < 0.0
            blmx = (-2.0 * brx if dmx * a6x > dmx * dmx else blx) if smx else 0.0
            brmx = (-2.0 * blx if dmx * a6x < -dmx * dmx else brx) if smx else 0.0
            dmlx = brmx - blmx
            a6lx = -3.0 * (blmx + brmx)
            fposx = (qy[-1, 0, 0] + brmx[-1, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dmlx[-1, 0, 0] - a6lx[-1, 0, 0] * (1.0 - 2.0 * cx[0, 0, 0] / 3.0)
            )
            fnegx = (qy[0, 0, 0] + blmx[0, 0, 0]) - 0.5 * cx[0, 0, 0] * (
                dmlx[0, 0, 0] + a6lx[0, 0, 0] * (1.0 + 2.0 * cx[0, 0, 0] / 3.0)
            )
            fx = cx[0, 0, 0] * (fposx if cx[0, 0, 0] >= 0.0 else fnegx)
            # y flux on qx
            aly = 7.0 / 12.0 * (qx[0, -1, 0] + qx[0, 0, 0]) - 1.0 / 12.0 * (
                qx[0, -2, 0] + qx[0, 1, 0]
            )
            bly = aly[0, 0, 0] - qx[0, 0, 0]
            bry = aly[0, 1, 0] - qx[0, 0, 0]
            dmy = bry - bly
            a6y = -3.0 * (bly + bry)
            smy = bly * bry < 0.0
            blmy = (-2.0 * bry if dmy * a6y > dmy * dmy else bly) if smy else 0.0
            brmy = (-2.0 * bly if dmy * a6y < -dmy * dmy else bry) if smy else 0.0
            dmly = brmy - blmy
            a6ly = -3.0 * (blmy + brmy)
            fposy = (qx[0, -1, 0] + brmy[0, -1, 0]) - 0.5 * cy[0, 0, 0] * (
                dmly[0, -1, 0] - a6ly[0, -1, 0] * (1.0 - 2.0 * cy[0, 0, 0] / 3.0)
            )
            fnegy = (qx[0, 0, 0] + blmy[0, 0, 0]) - 0.5 * cy[0, 0, 0] * (
                dmly[0, 0, 0] + a6ly[0, 0, 0] * (1.0 + 2.0 * cy[0, 0, 0] / 3.0)
            )
            fy = cy[0, 0, 0] * (fposy if cy[0, 0, 0] >= 0.0 else fnegy)
            qout = (
                q[0, 0, 0]
                - (fx[1, 0, 0] - fx[0, 0, 0])
                - (fy[0, 1, 0] - fy[0, 0, 0])
            )

    return fv_final


def make_flux_update_x(dtype, backend="jax", factor=1.0):
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"fv_upd_x_{np.dtype(dtype).name}_{factor}",
        externals={"FACTOR": factor},
        literal_precision=_literal_precision(dtype),
    )
    def update_x(q: Field, flux: Field, qout: Field):
        from __externals__ import FACTOR

        with computation(PARALLEL), interval(...):
            qout = q[0, 0, 0] - FACTOR * (flux[1, 0, 0] - flux[0, 0, 0])

    return update_x


def make_flux_update_y(dtype, backend="jax", factor=1.0):
    Field = gtscript.Field[dtype]

    @gtscript.stencil(
        backend=backend,
        name=f"fv_upd_y_{np.dtype(dtype).name}_{factor}",
        externals={"FACTOR": factor},
        literal_precision=_literal_precision(dtype),
    )
    def update_y(q: Field, flux: Field, qout: Field):
        from __externals__ import FACTOR

        with computation(PARALLEL), interval(...):
            qout = q[0, 0, 0] - FACTOR * (flux[0, 1, 0] - flux[0, 0, 0])

    return update_y


class FvAdvection:
    """2D finite-volume transport: Lin-Rood split PPM advection.

    ``step(q, cx, cy) -> q_new`` on physical K-leading (K, NI+2h+p, NJ+2h+p)
    buffers with periodic boundaries; Courant numbers are face-centered
    (cx at face i, cy at face j).  The whole step traces into one XLA
    program (or Pallas kernels with ``backend='pallas'``).
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
        self.backend = backend
        h = self.HALO
        self.oi = self.oj = h
        dom = (ni, nj, nk)
        origin = (self.oi, self.oj, 0)
        physical = backend in ("jax", "pallas")
        kw = dict(origin=origin, domain=dom, physical_layout=True) if physical else None

        self.xflux = make_xflux(dtype, backend)
        self.yflux = make_yflux(dtype, backend)
        self.upd_x_half = make_flux_update_x(dtype, backend, factor=0.5)
        self.upd_y_half = make_flux_update_y(dtype, backend, factor=0.5)
        self.upd_x = make_flux_update_x(dtype, backend, factor=1.0)
        self.upd_y = make_flux_update_y(dtype, backend, factor=1.0)
        if physical:
            kw_p = dict(kw, periodic=("I", "J"))
            self.fns = {
                "xflux": self.xflux.functional(**kw),
                "yflux": self.yflux.functional(**kw),
                "upd_x_half": self.upd_x_half.functional(**kw),
                "upd_y_half": self.upd_y_half.functional(**kw),
                "upd_x": self.upd_x.functional(**kw),
                "upd_y": self.upd_y.functional(**kw),
                # fused stages (3 kernels/step instead of 6 + fewer fills)
                "xadv_half": make_x_advect(dtype, backend, 0.5).functional(**kw),
                "yadv_half": make_y_advect(dtype, backend, 0.5).functional(**kw),
                "final": make_fv_final(dtype, backend).functional(**kw),
                # periodic product path: 2 kernels/step, ZERO fill passes
                # (halo wrap folded into the tile DMA on pallas)
                "xyadv_half_p": make_xy_advect(dtype, backend, 0.5).functional(**kw_p),
                "final_p": make_fv_final(dtype, backend).functional(**kw_p),
                # single-stencil step: qx/qy/fluxes as temporaries
                "step_p": make_fv_step(dtype, backend).functional(**kw_p),
                # non-periodic fused step: halos pre-filled externally
                # (the shard_map halo-exchange path; HALO=3 covers the
                # fused read extent exactly)
                "step": make_fv_step(dtype, backend).functional(**kw),
            }

    def field_shape(self) -> Tuple[int, int, int]:
        h = self.HALO
        return (self.nk, self.ni + 2 * h, self.nj + 2 * h)

    def init_state(self, seed: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(seed)
        shape = self.field_shape()
        q = rng.random(shape).astype(self.dtype)
        cx = (0.4 * (rng.random(shape) - 0.5)).astype(self.dtype)
        cy = (0.4 * (rng.random(shape) - 0.5)).astype(self.dtype)
        return {"q": q, "cx": cx, "cy": cy}

    # ------------------------------------------------------------------ #

    def fill_winds(self, cx, cy):
        """Periodically fill the Courant fields' halos once, for use with
        ``step_fn(winds_filled=True)``."""
        h = self.HALO
        return (
            periodic_fill(cx, h, self.ni, self.nj, self.oi, self.oj),
            periodic_fill(cy, h, self.ni, self.nj, self.oi, self.oj),
        )

    def step_fn(self, *, winds_filled: bool = False):
        """Pure jax step over physical buffers (jax/pallas backends).

        Periodic boundaries are an execution option of the stencils
        (``periodic=("I", "J")``): reads wrap in the kernels' tile DMA,
        so the step contains NO halo-fill passes at all -- two fused
        kernels move the minimum possible HBM traffic.  ``winds_filled``
        is accepted for API compatibility (pre-filled Courant halos are
        simply re-wrapped from the same interior values -- bitwise
        identical).
        """
        fns = self.fns

        def step(q, cx, cy):
            import jax.numpy as jnp

            zeros = jnp.zeros_like(q)
            return fns["step_p"](q=q, cx=cx, cy=cy, qout=zeros)["qout"]

        return step

    def local_step_fn(self):
        """Non-periodic step on halo-prefilled blocks: the shard_map /
        halo-exchange path (periodicity or physical boundaries are the
        exchange layer's concern, not the kernel's)."""
        fn = self.fns["step"]

        def step(q, cx, cy):
            import jax.numpy as jnp

            return fn(q=q, cx=cx, cy=cy, qout=jnp.zeros_like(q))["qout"]

        return step

    # ------------------------------------------------------------------ #

    def run_numpy_oracle(self, q, cx, cy):
        """Reference-semantics step on logical (I, J, K) numpy arrays.

        Executes the same stencils through the numpy oracle backend with
        the same staging/fill structure.
        """
        assert self.backend == "numpy"
        h, ni, nj, nk = self.HALO, self.ni, self.nj, self.nk
        origin = (h, h, 0)
        dom = (ni, nj, nk)

        def fill(a):
            a[:h] = a[ni : ni + h]
            a[h + ni : 2 * h + ni] = a[h : 2 * h]
            a[:, :h] = a[:, nj : nj + h]
            a[:, h + nj : 2 * h + nj] = a[:, h : 2 * h]
            return a

        q = fill(q.copy())
        fx0 = np.zeros_like(q)
        fy0 = np.zeros_like(q)
        qx = np.zeros_like(q)
        qy = np.zeros_like(q)
        self.xflux(q, cx, fx0, origin=origin, domain=dom)
        fill(fx0)
        self.upd_x_half(q, fx0, qx, origin=origin, domain=dom)
        self.yflux(q, cy, fy0, origin=origin, domain=dom)
        fill(fy0)
        self.upd_y_half(q, fy0, qy, origin=origin, domain=dom)
        fill(qx)
        fill(qy)
        fx = np.zeros_like(q)
        fy = np.zeros_like(q)
        self.xflux(qy, cx, fx, origin=origin, domain=dom)
        fill(fx)
        self.yflux(qx, cy, fy, origin=origin, domain=dom)
        fill(fy)
        q1 = np.zeros_like(q)
        q2 = np.zeros_like(q)
        self.upd_x(q, fx, q1, origin=origin, domain=dom)
        fill(q1)
        self.upd_y(q1, fy, q2, origin=origin, domain=dom)
        return q2

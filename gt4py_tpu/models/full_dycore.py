"""Combined mini-dycore timestep: hdiff + vertical advection + FVTP2D
tracer advection + semi-Lagrangian transport (the BASELINE "combined"
workload).  One call = one fused XLA program over physical K-leading
buffers."""

from typing import Dict, Tuple

import numpy as np

from .dycore import MiniDycore, periodic_fill
from .fv_advection import FvAdvection
from .semi_lagrangian import make_sl_stencil, semi_lagrangian_step


class FullDycore:
    """Prognostic u (diffused + vertically advected) plus a tracer q
    transported by FVTP2D and a second tracer by semi-Lagrangian
    interpolation."""

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
        self.dyn = MiniDycore(ni, nj, nk, dtype=dtype, backend=backend)
        self.fv = FvAdvection(ni, nj, nk, dtype=dtype, backend=backend)
        self.oi, self.oj = self.dyn.oi, self.dyn.oj
        assert self.dyn.field_shape() == self.fv.field_shape()
        # semi-Lagrangian transport as a STENCIL (windowed W=1, periodic
        # wrap in the kernel DMA) -- the jnp roll/select form costs
        # (2W+2)^2 full-array XLA passes (~6 ms at 512^2x80 f32 vs <1 ms
        # fused); winds are Courant numbers <= 0.4 cells
        if backend in ("jax", "pallas"):
            self.sl_fn = make_sl_stencil(dtype, backend, max_shift=1).functional(
                origin=(self.oi, self.oj, 0),
                domain=(ni, nj, nk),
                physical_layout=True,
                periodic=("I", "J"),
            )
        else:
            self.sl_fn = None

    def field_shape(self) -> Tuple[int, int, int]:
        return self.dyn.field_shape()

    def init_state(self, seed: int = 0) -> Dict[str, np.ndarray]:
        state = self.dyn.init_state(seed)
        fv_state = self.fv.init_state(seed + 1)
        state["q"] = fv_state["q"]
        state["cx"] = fv_state["cx"]
        state["cy"] = fv_state["cy"]
        rng = np.random.default_rng(seed + 2)
        state["qsl"] = rng.random(self.field_shape()).astype(self.dtype)
        return state

    def step_fn(self, *, dt: float = 0.5):
        dyn_step = self.dyn.step_fn()
        fv_step = self.fv.step_fn()
        ni, nj = self.ni, self.nj
        oi, oj = self.oi, self.oj

        sl_fn = self.sl_fn

        def step(state: Dict) -> Dict:
            import jax.numpy as jnp

            state = dyn_step(state)
            q = fv_step(state["q"], state["cx"], state["cy"])
            if sl_fn is not None:
                # semi-Lagrangian transport of qsl: one fused windowed-
                # interpolation kernel, periodic wrap in the tile DMA.
                # The winds are u = cx/dt, so the displacement u*dt/dx
                # is just cx -- pass the Courant fields directly with
                # dtdx = 1 (two full-array divisions saved; dt cancels)
                one = jnp.asarray(1.0, dtype=self.dtype)
                qsl = sl_fn(
                    q=state["qsl"],
                    u=state["cx"],
                    v=state["cy"],
                    qout=jnp.zeros_like(state["qsl"]),
                    dtdx=one,
                    dtdy=one,
                )["qout"]
            else:
                # backend-agnostic fallback (e.g. the numpy oracle):
                # windowed roll/select interpolation on the interior
                interior = (slice(None), slice(oi, oi + ni), slice(oj, oj + nj))
                qsl_int = semi_lagrangian_step(
                    state["qsl"][interior],
                    state["cx"][interior] / dt,
                    state["cy"][interior] / dt,
                    dt,
                    max_shift=1,
                )
                qsl = state["qsl"].at[interior].set(qsl_int) if hasattr(
                    state["qsl"], "at"
                ) else _np_set(state["qsl"], interior, qsl_int)
            new = dict(state)
            new["q"] = q
            new["qsl"] = qsl
            return new

        return step


def _np_set(arr, idx, value):
    out = np.array(arr, copy=True)
    out[idx] = np.asarray(value)
    return out

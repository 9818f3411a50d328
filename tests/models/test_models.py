"""Model-zoo validation: FVTP2D, semi-Lagrangian, spectral, mini-dycore."""

import numpy as np
import pytest

from gt4py_tpu.models.fv_advection import FvAdvection
from gt4py_tpu.models.semi_lagrangian import (
    semi_lagrangian_step,
    semi_lagrangian_step_numpy,
)
from gt4py_tpu.models.spectral import (
    poisson_solve,
    poisson_solve_numpy,
    spectral_filter,
    spectral_filter_numpy,
)


NI = NJ = 16
NK = 4
H = FvAdvection.HALO


def make_fv(backend, dtype=np.float64):
    return FvAdvection(NI, NJ, NK, dtype=dtype, backend=backend)


def _logical_state(model, seed=0):
    """Oracle-side logical (I, J, K) arrays matching a physical state."""
    st = model.init_state(seed)
    return {k: np.transpose(v, (1, 2, 0)).copy() for k, v in st.items()}


def test_fv_advection_jax_matches_oracle():
    import jax
    import jax.numpy as jnp

    jax_model = make_fv("jax")
    np_model = make_fv("numpy")

    st = jax_model.init_state(seed=1)
    step = jax_model.step_fn()
    q_jax = np.asarray(jax.jit(step)(*(jnp.asarray(st[k]) for k in ("q", "cx", "cy"))))

    # oracle works on tight logical (I, J, K) arrays at origin (h, h):
    # slice the halo window out of the aligned physical buffers
    oi, oj = jax_model.oi, jax_model.oj
    win = (slice(None), slice(oi - H, oi + NI + H), slice(oj - H, oj + NJ + H))
    L = {k: np.transpose(v[win], (1, 2, 0)).copy() for k, v in st.items()}
    q_np = np_model.run_numpy_oracle(L["q"], L["cx"], L["cy"])

    np.testing.assert_allclose(
        np.transpose(q_jax, (1, 2, 0))[oi : oi + NI, oj : oj + NJ],
        q_np[H : H + NI, H : H + NJ],
        rtol=1e-12,
        atol=1e-12,
    )


def test_fv_advection_conserves_mass():
    import jax
    import jax.numpy as jnp

    model = make_fv("jax")
    st = model.init_state(seed=2)
    step = jax.jit(model.step_fn())
    q = jnp.asarray(st["q"])
    oi, oj = model.oi, model.oj
    total0 = float(jnp.sum(q[:, oi : oi + NI, oj : oj + NJ]))
    for _ in range(5):
        q = step(q, jnp.asarray(st["cx"]), jnp.asarray(st["cy"]))
    total = float(jnp.sum(q[:, oi : oi + NI, oj : oj + NJ]))
    assert abs(total - total0) < 1e-9 * abs(total0)


def test_fv_advection_preserves_constant():
    """Flux-form transport preserves constants for non-divergent winds."""
    import jax
    import jax.numpy as jnp

    model = make_fv("jax")
    shape = model.field_shape()
    q = jnp.full(shape, 2.5)
    cx = jnp.full(shape, 0.37)
    cy = jnp.full(shape, -0.21)
    step = jax.jit(model.step_fn())
    out = step(q, cx, cy)
    np.testing.assert_allclose(
        np.asarray(out)[:, model.oi : model.oi + NI, model.oj : model.oj + NJ],
        2.5,
        rtol=1e-13,
    )


def test_fv_advection_monotone_no_overshoot():
    """A step function advected with uniform wind must not overshoot."""
    import jax
    import jax.numpy as jnp

    model = make_fv("jax")
    shape = model.field_shape()
    q = np.zeros(shape)
    q[:, H + 4 : H + 10, H + 4 : H + 10] = 1.0
    cx = np.full(shape, 0.3)
    cy = np.full(shape, 0.2)
    step = jax.jit(model.step_fn())
    qj = jnp.asarray(q)
    for _ in range(10):
        qj = step(qj, jnp.asarray(cx), jnp.asarray(cy))
    interior = np.asarray(qj)[:, model.oi : model.oi + NI, model.oj : model.oj + NJ]
    # 1D PPM is monotone; the 2D split introduces small cross-term
    # oscillations (Lin & Rood 1996) -- bound them tightly
    assert interior.min() >= -0.05
    assert interior.max() <= 1.05


def test_semi_lagrangian_integer_shift_exact():
    rng = np.random.default_rng(0)
    q = rng.random((NK, NI, NJ))
    u = np.full((NK, NI, NJ), 3.0)
    v = np.full((NK, NI, NJ), -2.0)
    out = np.asarray(semi_lagrangian_step(q, u, v, dt=1.0))
    expected = np.roll(np.roll(q, 3, axis=1), -2, axis=2)
    np.testing.assert_allclose(out, expected, rtol=1e-12, atol=1e-12)


def test_semi_lagrangian_matches_numpy():
    rng = np.random.default_rng(1)
    q = rng.random((NK, NI, NJ))
    u = rng.random((NK, NI, NJ)) * 2 - 1
    v = rng.random((NK, NI, NJ)) * 2 - 1
    out_j = np.asarray(semi_lagrangian_step(q, u, v, dt=0.7))
    out_n = semi_lagrangian_step_numpy(q, u, v, dt=0.7)
    np.testing.assert_allclose(out_j, out_n, rtol=1e-12, atol=1e-12)


def test_spectral_filter_matches_numpy():
    rng = np.random.default_rng(2)
    q = rng.random((NK, NI, NJ))
    out_j = np.asarray(spectral_filter(q, cutoff=1.0))
    out_n = spectral_filter_numpy(q, cutoff=1.0)
    np.testing.assert_allclose(out_j, out_n, rtol=1e-10, atol=1e-12)


def test_poisson_solve_inverts_laplacian():
    rng = np.random.default_rng(3)
    rhs = rng.random((NK, NI, NJ))
    rhs -= rhs.mean(axis=(1, 2), keepdims=True)  # solvable gauge
    p = np.asarray(poisson_solve(rhs))
    # discrete-spectrum laplacian via the same spectral operators
    lap = (
        np.roll(p, 1, 1) + np.roll(p, -1, 1) + np.roll(p, 1, 2) + np.roll(p, -1, 2)
        - 4 * p
    )
    # spectral solve inverts the *spectral* laplacian; verify via numpy path
    p_n = poisson_solve_numpy(rhs)
    np.testing.assert_allclose(p, p_n, rtol=1e-10, atol=1e-12)
    # and the solution really has the right curvature on smooth fields:
    from gt4py_tpu.models.spectral import spectral_filter_numpy as filt

    rhs_smooth = filt(rhs, cutoff=0.8)
    p2 = poisson_solve_numpy(rhs_smooth)
    # spectral laplacian of p2 equals rhs_smooth
    ni, nj = NI, NJ
    kx = np.fft.fftfreq(ni) * 2 * np.pi
    ky = np.fft.rfftfreq(nj) * 2 * np.pi
    k2 = kx.reshape(1, -1, 1) ** 2 + ky.reshape(1, 1, -1) ** 2
    lap_spec = np.fft.irfft2(
        np.fft.rfft2(p2, axes=(1, 2)) * (-k2), s=(ni, nj), axes=(1, 2)
    )
    np.testing.assert_allclose(lap_spec, rhs_smooth, rtol=1e-8, atol=1e-10)


def test_semi_lagrangian_windowed_matches_gather():
    """The bounded-displacement roll/select formulation is bitwise-equal
    to the general-gather path for in-window displacements."""
    rng = np.random.default_rng(3)
    q = rng.random((NK, NI, NJ))
    u = rng.random((NK, NI, NJ)) * 2 - 1
    v = rng.random((NK, NI, NJ)) * 2 - 1
    out_g = np.asarray(semi_lagrangian_step(q, u, v, dt=0.7))
    out_w = np.asarray(semi_lagrangian_step(q, u, v, dt=0.7, max_shift=1))
    np.testing.assert_array_equal(out_w, out_g)
    # larger displacements need a wider window
    u3 = np.full((NK, NI, NJ), 3.0)
    out_g3 = np.asarray(semi_lagrangian_step(q, u3, v, dt=1.0))
    out_w3 = np.asarray(semi_lagrangian_step(q, u3, v, dt=1.0, max_shift=3))
    np.testing.assert_array_equal(out_w3, out_g3)


def test_full_dycore_numpy_backend_step():
    """FullDycore with the numpy backend uses the backend-agnostic
    windowed SL fallback (review fix: sl_fn=None crashed)."""
    from gt4py_tpu.models.full_dycore import FullDycore

    m = FullDycore(8, 8, 3, dtype=np.float64, backend="jax")
    # simulate a backend without the stencil kernel path
    m.sl_fn = None
    import jax.numpy as jnp

    state = {k: jnp.asarray(v) for k, v in m.init_state().items()}
    out = m.step_fn()(state)
    assert np.isfinite(np.asarray(out["qsl"])).all()


# --------------------------- shallow water --------------------------- #


def _sw(backend, dtype=np.float64, **kw):
    from gt4py_tpu.models.shallow_water import ShallowWater

    return ShallowWater(NI, NJ, NK, dtype=dtype, backend=backend, **kw)


def test_shallow_water_jax_matches_oracle():
    import jax
    import jax.numpy as jnp

    from gt4py_tpu.models.shallow_water import ShallowWater

    jm = _sw("jax")
    nm = _sw("numpy")
    hw = ShallowWater.HALO
    st = jm.init_state(seed=1)
    step = jax.jit(jm.step_fn())
    outs = step(*(jnp.asarray(st[k]) for k in ("h", "u", "v")))

    oi, oj = jm.oi, jm.oj
    win = (slice(None), slice(oi - hw, oi + NI + hw), slice(oj - hw, oj + NJ + hw))
    L = {k: np.transpose(v[win], (1, 2, 0)).copy() for k, v in st.items()}
    hn, un, vn = nm.run_numpy_oracle(L["h"], L["u"], L["v"])

    for got, ref in zip(outs, (hn, un, vn)):
        np.testing.assert_allclose(
            np.transpose(np.asarray(got), (1, 2, 0))[oi : oi + NI, oj : oj + NJ],
            ref[hw : hw + NI, hw : hw + NJ],
            rtol=1e-12,
            atol=1e-14,
        )


def test_shallow_water_conserves_mass():
    import jax
    import jax.numpy as jnp

    m = _sw("jax")
    st = m.init_state(seed=2)
    step = jax.jit(m.step_fn())
    h = jnp.asarray(st["h"])
    u = jnp.asarray(st["u"])
    v = jnp.asarray(st["v"])
    oi, oj = m.oi, m.oj
    total0 = float(jnp.sum(h[:, oi : oi + NI, oj : oj + NJ]))
    for _ in range(20):
        h, u, v = step(h, u, v)
    total = float(jnp.sum(h[:, oi : oi + NI, oj : oj + NJ]))
    assert abs(total - total0) < 1e-12 * abs(total0)


def test_shallow_water_stable_energy_bounded():
    """Forward-backward linear SWE is neutrally stable for c*dt/dx < 2:
    the energy norm must stay bounded over a long run (f32)."""
    import jax
    import jax.numpy as jnp

    m = _sw("jax", dtype=np.float32)
    st = m.init_state(seed=3)
    step = jax.jit(m.step_fn())
    h = jnp.asarray(st["h"])
    u = jnp.asarray(st["u"])
    v = jnp.asarray(st["v"])
    oi, oj = m.oi, m.oj
    sl = (slice(None), slice(oi, oi + NI), slice(oj, oj + NJ))
    g, H = m.params["g"], m.params["H"]

    def energy(h, u, v):
        return float(
            jnp.sum(g * h[sl] ** 2 + H * (u[sl] ** 2 + v[sl] ** 2))
        )

    e0 = energy(h, u, v)
    for _ in range(100):
        h, u, v = step(h, u, v)
    e1 = energy(h, u, v)
    assert np.isfinite(e1)
    assert e1 < 4.0 * e0  # bounded (no exponential growth)


def test_shallow_water_pallas_matches_jax():
    import jax
    import jax.numpy as jnp

    jm = _sw("jax")
    pm = _sw("pallas")
    st = jm.init_state(seed=4)
    args = tuple(jnp.asarray(st[k]) for k in ("h", "u", "v"))
    outs_j = jax.jit(jm.step_fn())(*args)
    outs_p = jax.jit(pm.step_fn())(*args)
    for a, b in zip(outs_j, outs_p):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

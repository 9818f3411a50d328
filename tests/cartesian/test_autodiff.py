"""Differentiability: jax.grad through stencil programs.

The reference has no adjoint/autodiff story at all; here stencils are
traced jax programs, so gradients come from the same lowering.  Gradients
are validated against central finite differences.
"""

import numpy as np
import pytest

from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    computation,
    interval,
)

# kernel numerics for every stencil class, not only the default rule's
pytestmark = pytest.mark.usefixtures("all_kernel_classes")

Field3D = gtscript.Field[np.float64]


def central_diff(f, x, eps=1e-6):
    g = np.zeros_like(x)
    it = np.nditer(x, flags=["multi_index"])
    for _ in it:
        idx = it.multi_index
        xp = x.copy(); xp[idx] += eps
        xm = x.copy(); xm[idx] -= eps
        g[idx] = (f(xp) - f(xm)) / (2 * eps)
    return g


def test_grad_through_parallel_stencil():
    import jax
    import jax.numpy as jnp

    @gtscript.stencil(backend="jax")
    def smooth(inp: Field3D, out: Field3D):
        with computation(PARALLEL), interval(...):
            out = 0.25 * (inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0])

    fn = smooth.functional(origin=(1, 1, 0), domain=(4, 4, 2))

    def loss(inp):
        out = fn(inp=inp, out=jnp.zeros_like(inp))["out"]
        return jnp.sum(out**2)

    rng = np.random.default_rng(0)
    x = rng.random((6, 6, 2))
    g = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    g_fd = central_diff(lambda a: float(loss(jnp.asarray(a))), x)
    np.testing.assert_allclose(g, g_fd, rtol=1e-5, atol=1e-7)


def test_grad_through_tridiagonal_scan():
    """Gradients flow through the FORWARD/BACKWARD lax.scan lowering."""
    import jax
    import jax.numpy as jnp

    @gtscript.stencil(backend="jax")
    def cumsum(inp: Field3D, out: Field3D):
        with computation(FORWARD):
            with interval(0, 1):
                out = inp
            with interval(1, None):
                out = out[0, 0, -1] + inp

    fn = cumsum.functional(origin=(0, 0, 0), domain=(2, 2, 5))

    def loss(inp):
        out = fn(inp=inp, out=jnp.zeros_like(inp))["out"]
        return jnp.sum(out * out)

    rng = np.random.default_rng(1)
    x = rng.random((2, 2, 5))
    g = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    g_fd = central_diff(lambda a: float(loss(jnp.asarray(a))), x)
    np.testing.assert_allclose(g, g_fd, rtol=1e-5, atol=1e-7)


def test_grad_through_dycore_step():
    """End-to-end: gradient of a scalar diagnostic of the full MiniDycore
    timestep with respect to the initial state."""
    import jax
    import jax.numpy as jnp

    from gt4py_tpu.models import MiniDycore

    model = MiniDycore(8, 8, 4, dtype=np.float64, backend="jax")
    step = model.step_fn()
    state = {k: jnp.asarray(v) for k, v in model.init_state().items()}

    def loss(u):
        s = dict(state)
        s["u"] = u
        out = step(s)
        return jnp.sum(out["u"] ** 2)

    g = jax.grad(loss)(state["u"])
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 0

    # directional-derivative check against finite differences
    rng = np.random.default_rng(2)
    v = jnp.asarray(rng.random(state["u"].shape))
    eps = 1e-6
    fd = (loss(state["u"] + eps * v) - loss(state["u"] - eps * v)) / (2 * eps)
    dot = jnp.vdot(g, v)
    np.testing.assert_allclose(float(dot), float(fd), rtol=1e-4)


def test_jvp_through_pallas_backend():
    """Forward-mode autodiff works through the kernel path too: the
    custom_jvp routes tangents through the XLA executor, so jvp/jacfwd
    match the jax backend exactly (a custom_vjp would forbid jvp)."""
    import jax
    import jax.numpy as jnp

    def defn(inp: Field3D, out: Field3D):
        with computation(PARALLEL), interval(...):
            out = inp[1, 0, 0] * inp

    fns = {
        be: gtscript.stencil(backend=be, name=f"jvp_{be}")(defn).functional(
            origin=(0, 0, 0), domain=(4, 5, 2)
        )
        for be in ("jax", "pallas")
    }
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.random((5, 5, 2)))
    t = jnp.asarray(rng.random((5, 5, 2)))
    res = {}
    for be, fn in fns.items():
        f = lambda a, fn=fn: fn(inp=a, out=jnp.zeros_like(a))["out"]
        res[be] = jax.jvp(f, (x,), (t,))
    np.testing.assert_allclose(
        np.asarray(res["pallas"][0]), np.asarray(res["jax"][0]), rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(res["pallas"][1]), np.asarray(res["jax"][1]), rtol=1e-12
    )
    assert float(jnp.abs(res["pallas"][1]).max()) > 0


def test_grad_through_pallas_backend():
    """The pallas kernel path is differentiable: the custom VJP routes the
    backward pass through the XLA executor (identical numerics), so grads
    match the jax backend exactly."""
    import jax
    import jax.numpy as jnp

    def defn(inp: Field3D, out: Field3D):
        with computation(PARALLEL), interval(...):
            lap = inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0]
            out = inp - 0.1 * (lap - 4.0 * inp)

    fns = {}
    for be in ("jax", "pallas"):
        st = gtscript.stencil(backend=be, name=f"ad_{be}")(defn)
        fns[be] = st.functional(origin=(1, 1, 0), domain=(6, 6, 3))

    def loss(fn, inp):
        out = fn(inp=inp, out=jnp.zeros_like(inp))["out"]
        return jnp.sum(out**2)

    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.random((8, 8, 3)))
    g_jax = jax.grad(lambda a: loss(fns["jax"], a))(x)
    g_pal = jax.grad(lambda a: loss(fns["pallas"], a))(x)
    np.testing.assert_allclose(np.asarray(g_pal), np.asarray(g_jax), rtol=1e-12)
    assert float(jnp.abs(g_pal).max()) > 0


def test_grad_through_pallas_scan_and_scalar():
    """Gradients through a pallas serial-K stencil, including with respect
    to a traced scalar parameter, under jit."""
    import jax
    import jax.numpy as jnp

    def defn(inp: Field3D, out: Field3D, *, w: np.float64):
        with computation(FORWARD):
            with interval(0, 1):
                out = w * inp
            with interval(1, None):
                out = out[0, 0, -1] + w * inp

    sts = {
        be: gtscript.stencil(backend=be, name=f"ad_scan_{be}")(defn)
        for be in ("jax", "pallas")
    }
    fns = {be: st.functional(origin=(0, 0, 0), domain=(4, 4, 5))
           for be, st in sts.items()}

    def loss(fn, inp, w):
        out = fn(inp=inp, out=jnp.zeros_like(inp), w=w)["out"]
        return jnp.sum(out * out)

    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.random((4, 4, 5)))
    w0 = jnp.asarray(1.3)
    for argnum in (0, 1):
        g_jax = jax.jit(jax.grad(lambda a, w: loss(fns["jax"], a, w), argnum))(x, w0)
        g_pal = jax.jit(jax.grad(lambda a, w: loss(fns["pallas"], a, w), argnum))(x, w0)
        np.testing.assert_allclose(
            np.asarray(g_pal), np.asarray(g_jax), rtol=1e-12,
            err_msg=f"argnum {argnum}",
        )

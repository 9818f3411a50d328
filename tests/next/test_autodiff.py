"""jax.grad through the field-view DSL (beyond the reference: gt4py has
no autodiff story).

Fields are jax pytrees and the parsed operators stage into pure jax
programs, so reverse-mode adjoints of operator/scan compositions come
for free -- validated against central finite differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gt4py_tpu.next as gtx
from gt4py_tpu.next import Dims, Field

# kernel numerics for every stencil class, not only the default rule's
pytestmark = pytest.mark.usefixtures("all_kernel_classes")

I = gtx.Dimension("I")
K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)
Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))


@gtx.field_operator
def energy_op(f: Field[Dims[I, K], gtx.float64]) -> Field[Dims[I, K], gtx.float64]:
    g = f(Ioff[1]) - f
    return g * g


@gtx.scan_operator(axis=K, forward=True, init=0.0)
def damped_sum(c: float, x: float) -> float:
    return c * 0.9 + x


def _fd_grad(loss, data, eps=1e-6):
    fd = np.zeros_like(data)
    it = np.nditer(data, flags=["multi_index"])
    for _ in it:
        ix = it.multi_index
        dp = data.copy()
        dp[ix] += eps
        dm = data.copy()
        dm[ix] -= eps
        fd[ix] = (float(loss(jnp.asarray(dp))) - float(loss(jnp.asarray(dm)))) / (
            2 * eps
        )
    return fd


def test_grad_through_operator_and_scan():
    data = np.random.default_rng(0).random((6, 4))

    def loss(arr):
        f = gtx.as_field((I, K), arr)
        return jnp.sum(damped_sum(energy_op(f)).data)

    g = jax.grad(loss)(jnp.asarray(data))
    np.testing.assert_allclose(np.asarray(g), _fd_grad(loss, data), atol=5e-9)


def test_grad_wrt_scalar_parameter():
    @gtx.field_operator
    def scaled(
        f: Field[Dims[I, K], gtx.float64], w: gtx.float64
    ) -> Field[Dims[I, K], gtx.float64]:
        d = f(Ioff[1]) - f
        return gtx.where(d > 0.0, w * d, 0.5 * w * d)

    data = np.random.default_rng(1).random((5, 3)) - 0.5

    def loss(w):
        f = gtx.as_field((I, K), data)
        return jnp.sum(scaled(f, w).data ** 2)

    g = float(jax.grad(loss)(0.7))
    eps = 1e-6
    fd = (float(loss(0.7 + eps)) - float(loss(0.7 - eps))) / (2 * eps)
    assert abs(g - fd) < 1e-7


def test_jit_grad_composition():
    """jit(grad(...)) of an operator pipeline stages into one program."""
    data = np.random.default_rng(2).random((6, 4))

    def loss(arr):
        f = gtx.as_field((I, K), arr)
        return jnp.sum(damped_sum(energy_op(f)).data)

    g_eager = jax.grad(loss)(jnp.asarray(data))
    g_jit = jax.jit(jax.grad(loss))(jnp.asarray(data))
    np.testing.assert_array_equal(np.asarray(g_eager), np.asarray(g_jit))


def test_grad_backward_scan():
    @gtx.scan_operator(axis=K, forward=False, init=0.0)
    def back(c: float, x: float) -> float:
        return 0.5 * c + x * x

    data = np.random.default_rng(3).random((4, 5))

    def loss(arr):
        f = gtx.as_field((I, K), arr)
        return jnp.sum(back(f).data)

    g = jax.grad(loss)(jnp.asarray(data))
    np.testing.assert_allclose(np.asarray(g), _fd_grad(loss, data), atol=5e-9)


def test_grad_through_pallas_bridge_kernel():
    """jax.grad composes with the bridge's compiled kernels: the pallas
    backend's custom_vjp routes the backward pass through the XLA
    executor (identical numerics), so kernel-speed forward + adjoints
    also hold on the next pallas backend (r4)."""
    import jax
    import jax.numpy as jnp

    J = gtx.Dimension("J")
    FT = Field[Dims[I, J, K], gtx.float64]

    @gtx.field_operator
    def op(a: FT) -> FT:
        return (a(Ioff[1]) - a) * (a(Ioff[-1]) + 2.0)

    data = np.random.default_rng(0).random((10, 6, 4))
    dom = gtx.Domain(
        (I, J, K),
        (gtx.UnitRange(0, 10), gtx.UnitRange(0, 6), gtx.UnitRange(0, 4)),
    )
    bound = op.with_backend("pallas")

    def loss(x):
        return jnp.sum(bound(gtx.Field(dom, x)).data ** 2)

    g = jax.grad(loss)(jnp.asarray(data))
    eps = 1e-6
    rng = np.random.default_rng(1)
    for _ in range(3):
        i, j, k = rng.integers(2, 8), rng.integers(0, 6), rng.integers(0, 4)
        d = np.zeros_like(data)
        d[i, j, k] = eps
        fd = (loss(jnp.asarray(data + d)) - loss(jnp.asarray(data - d))) / (
            2 * eps
        )
        np.testing.assert_allclose(np.asarray(g)[i, j, k], float(fd), rtol=1e-5)


def test_grad_through_unstructured_affine_gather(monkeypatch):
    """Adjoints flow through planned window gathers (affine_remap):
    grad of an FVM energy functional with the affine plan active is
    BITWISE equal to the take-path grad (both are the same linear
    gather), and matches finite differences at sampled vertices."""
    from gt4py_tpu.next import FieldOffset, neighbor_sum
    from gt4py_tpu.next import affine_remap as ar
    from gt4py_tpu.next.testing import (
        E2VDim,
        Edge,
        V2EDim,
        Vertex,
        grid_mesh,
    )

    mesh = grid_mesh(64)
    E2V = FieldOffset("E2V", source=Vertex, target=(Edge, E2VDim))
    V2E = FieldOffset("V2E", source=Edge, target=(Vertex, V2EDim))

    @gtx.field_operator
    def gradient(
        psi: Field[Dims[Vertex], gtx.float64],
    ) -> Field[Dims[Edge], gtx.float64]:
        return psi(E2V[1]) - psi(E2V[0])

    @gtx.field_operator
    def divergence(
        flux: Field[Dims[Edge], gtx.float64],
        sign: Field[Dims[Vertex, V2EDim], gtx.float64],
    ) -> Field[Dims[Vertex], gtx.float64]:
        return neighbor_sum(flux(V2E) * sign, axis=V2EDim)

    t = np.asarray(mesh.v2e.table)
    first = np.asarray(mesh.e2v.table)[np.clip(t, 0, mesh.n_edges - 1), 0]
    sign_np = np.where(
        t == -1,
        0.0,
        np.where(first == np.arange(mesh.n_vertices)[:, None], 1.0, -1.0),
    )
    psi_np = np.random.default_rng(31).random(mesh.n_vertices)

    def loss_of(provider):
        sign = gtx.as_field((Vertex, V2EDim), jnp.asarray(sign_np))

        def loss(p):
            psi = gtx.as_field((Vertex,), p)
            g = gradient(psi, offset_provider=provider)
            d = divergence(g, sign, offset_provider=provider)
            return jnp.sum(d.data**2)

        return loss

    grad_aff = np.asarray(
        jax.grad(loss_of({"E2V": mesh.e2v, "V2E": mesh.v2e}))(
            jnp.asarray(psi_np)
        )
    )
    assert ar.plan_for(mesh.e2v) is not None  # plan really engaged
    monkeypatch.setenv("GT4PY_TPU_AFFINE_GATHER", "0")
    mesh2 = grid_mesh(64)  # fresh connectivities: no cached plans
    grad_take = np.asarray(
        jax.grad(loss_of({"E2V": mesh2.e2v, "V2E": mesh2.v2e}))(
            jnp.asarray(psi_np)
        )
    )
    assert ar.plan_for(mesh2.e2v) is None
    assert np.array_equal(grad_aff, grad_take)

    loss_np = loss_of({"E2V": mesh.e2v, "V2E": mesh.v2e})
    eps = 1e-6
    for v in (0, 65, 2113, mesh.n_vertices - 1):
        dp = psi_np.copy()
        dp[v] += eps
        dm = psi_np.copy()
        dm[v] -= eps
        fd = (float(loss_np(jnp.asarray(dp))) - float(loss_np(jnp.asarray(dm)))) / (
            2 * eps
        )
        np.testing.assert_allclose(grad_aff[v], fd, rtol=2e-4)

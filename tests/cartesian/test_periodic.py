"""Periodic execution semantics (``periodic=("I", "J")``).

Semantics (defined by the numpy oracle, numpy_backend._periodic_fill):
before the stencil runs, the I/J halos of every field read with nonzero
horizontal extent are filled from the opposite interior edge, width = the
field's read extent.  The jax backend pre-fills functionally at trace
entry; the pallas backend fills the same way before its kernels,
bitwise-identical by construction.

The reference has no such execution option (models there fill halos by
hand between stages); this is the replacement for those
fill passes -- see models/fv_advection.py.
"""

import numpy as np
import pytest

from gt4py_tpu import storage
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import BACKWARD, FORWARD, PARALLEL, computation, interval

# kernel numerics for every stencil class, not only the default rule's
pytestmark = pytest.mark.usefixtures("all_kernel_classes")

F = gtscript.Field[np.float64]

NI, NJ, NK = 24, 16, 5
H = 2
SHAPE = (NI + 2 * H, NJ + 2 * H, NK)


def _lap(a: F, b: F):
    with computation(PARALLEL), interval(...):
        b = (a[1, 0, 0] + a[-1, 0, 0] + a[0, 2, 0] + a[0, -2, 0]) - 4.0 * a


def _asym(a: F, b: F):
    # asymmetric extents: reads only backward in I, only forward in J
    with computation(PARALLEL), interval(...):
        b = a[-2, 0, 0] + a[0, 1, 0]


def _two_stage(a: F, b: F):
    # compound read extent through a temporary: a's wrap halo must cover
    # the *accumulated* extent (tmp offsets + a offsets), exercising the
    # extent-analysis-driven fill width.  (A field read with horizontal
    # extent AND written is illegal GTScript -- the race validator bans
    # it -- so the read+written periodic case cannot arise for I/J.)
    with computation(PARALLEL), interval(...):
        tmp = a[1, 0, 0] + a[0, -1, 0]
        b = tmp[-1, 0, 0] + tmp[0, 1, 0]


def _serial(a: F, b: F):
    # serial-K (mode B on pallas): periodic handled via pre-fill
    with computation(FORWARD):
        with interval(0, 1):
            b = a[1, 0, 0] + a[0, -1, 0]
        with interval(1, None):
            b = b[0, 0, -1] + a[-1, 0, 0]


def _manual_oracle(defn, a0):
    """Explicit periodic_fill of read halos + plain numpy-backend run."""
    st = gtscript.stencil(backend="numpy")(defn)
    am = a0.copy()
    am[:H] = am[NI : NI + H]
    am[NI + H :] = am[H : 2 * H]
    am[:, :H] = am[:, NJ : NJ + H]
    am[:, NJ + H :] = am[:, H : 2 * H]
    b0 = np.arange(np.prod(SHAPE), dtype=np.float64).reshape(SHAPE) / 100.0
    bm = b0.copy()
    bm[:H] = bm[NI : NI + H]
    bm[NI + H :] = bm[H : 2 * H]
    bm[:, :H] = bm[:, NJ : NJ + H]
    bm[:, NJ + H :] = bm[:, H : 2 * H]
    af = storage.from_array(am, backend="numpy", aligned_index=(H, H, 0))
    bf = storage.from_array(bm, backend="numpy", aligned_index=(H, H, 0))
    extra = {}
    if len(st.ir.api_params) > 2:
        extra["c"] = storage.zeros(SHAPE, backend="numpy", aligned_index=(H, H, 0))
    st(af, bf, domain=(NI, NJ, NK), **extra)
    return np.asarray(bf)


def _run_periodic(defn, backend, a0):
    st = gtscript.stencil(backend=backend)(defn)
    b0 = np.arange(np.prod(SHAPE), dtype=np.float64).reshape(SHAPE) / 100.0
    a = storage.from_array(a0.copy(), backend="numpy", aligned_index=(H, H, 0))
    b = storage.from_array(b0.copy(), backend="numpy", aligned_index=(H, H, 0))
    extra = {}
    if len(st.ir.api_params) > 2:
        extra["c"] = storage.zeros(SHAPE, backend="numpy", aligned_index=(H, H, 0))
    st(a, b, domain=(NI, NJ, NK), periodic=("I", "J"), **extra)
    return np.asarray(b)


INTERIOR = (slice(H, H + NI), slice(H, H + NJ), slice(None))


@pytest.mark.parametrize("backend", ["numpy", "jax", "pallas"])
@pytest.mark.parametrize("defn", [_lap, _asym, _two_stage, _serial])
def test_periodic_matches_explicit_fill(backend, defn):
    rng = np.random.default_rng(7)
    a0 = rng.random(SHAPE)
    expect = _manual_oracle(defn, a0)
    got = _run_periodic(defn, backend, a0)
    assert np.array_equal(got[INTERIOR], expect[INTERIOR])


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_periodic_functional_path(backend):
    """functional(periodic=...) on physical (K, I, J) buffers."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    a0 = rng.random(SHAPE)
    expect = _manual_oracle(_lap, a0)

    st = gtscript.stencil(backend=backend)(_lap)
    fn = st.functional(
        origin=(H, H, 0),
        domain=(NI, NJ, NK),
        physical_layout=True,
        periodic=("I", "J"),
    )
    phys_a = jnp.asarray(np.transpose(a0, (2, 0, 1)))
    phys_b = jnp.zeros_like(phys_a)
    out = jax.jit(lambda a, b: fn(a=a, b=b)["b"])(phys_a, phys_b)
    got = np.transpose(np.asarray(out), (1, 2, 0))
    assert np.array_equal(got[INTERIOR], expect[INTERIOR])


def test_periodic_axis_subset():
    """periodic=("I",) wraps I only; J halos keep their original values."""
    rng = np.random.default_rng(5)
    a0 = rng.random(SHAPE)

    st = gtscript.stencil(backend="numpy")(_lap)
    am = a0.copy()
    am[:H] = am[NI : NI + H]
    am[NI + H :] = am[H : 2 * H]
    af = storage.from_array(am, backend="numpy", aligned_index=(H, H, 0))
    bf = storage.zeros(SHAPE, backend="numpy", aligned_index=(H, H, 0))
    st(af, bf, domain=(NI, NJ, NK))
    expect = np.asarray(bf)

    a = storage.from_array(a0.copy(), backend="numpy", aligned_index=(H, H, 0))
    b = storage.zeros(SHAPE, backend="numpy", aligned_index=(H, H, 0))
    st(a, b, domain=(NI, NJ, NK), periodic=("I",))
    assert np.array_equal(np.asarray(b)[INTERIOR], expect[INTERIOR])


def test_periodic_domain_too_small():
    st = gtscript.stencil(backend="numpy")(_lap)
    a = storage.ones((6, 6, 3), backend="numpy", aligned_index=(2, 2, 0))
    b = storage.zeros((6, 6, 3), backend="numpy", aligned_index=(2, 2, 0))
    with pytest.raises(ValueError, match="periodic"):
        st(a, b, domain=(1, 1, 3), periodic=("I", "J"))


def test_periodic_bad_axis():
    from gt4py_tpu.cartesian.stencil_object import ArgumentError

    st = gtscript.stencil(backend="numpy")(_lap)
    a = storage.ones(SHAPE, backend="numpy", aligned_index=(H, H, 0))
    b = storage.zeros(SHAPE, backend="numpy", aligned_index=(H, H, 0))
    with pytest.raises(ArgumentError, match="periodic"):
        st(a, b, domain=(NI, NJ, NK), periodic=("K",))

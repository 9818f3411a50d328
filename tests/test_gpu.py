"""Card-only suite: the column kernel compiled by Triton on a GPU.

Interpret mode runs the grid one block at a time, so it cannot see races
between blocks, the Triton compiler's own refusals, or GPU arithmetic
(FMA contraction, libdevice).  These tests run the kernel path on the card
against the numpy oracle.  They skip on the CPU; ``chip_smoke.py`` runs
them on the card (``pytest -m gpu tests/test_gpu.py`` in its process).
"""

import numpy as np
import pytest

from gt4py_tpu.testing.program_gen import run_differential_case

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu", "all_kernel_classes")]

# f32 on the card: an ulp of FMA contraction or libdevice rounding,
# amplified by cancellation in random expressions; a data-dependent branch
# within an ulp of its threshold may flip (max_flip_fraction)
F32 = dict(dtype=np.float32, rtol=1e-3, atol=2e-4, max_flip_fraction=1e-4)


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_f64_on_gpu(seed):
    run_differential_case(seed, backends=("pallas",), rtol=1e-11, atol=1e-11,
                          max_flip_fraction=1e-4)


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_f32_wide_on_gpu(seed):
    """J = 128 with 128-point halos: several blocks per row."""
    run_differential_case(seed, backends=("pallas",), aligned=True, **F32)


@pytest.mark.parametrize("seed", range(6))
def test_periodic_fuzz_on_gpu(seed):
    run_differential_case(seed, backends=("pallas",), aligned=True,
                          periodic=("I", "J"), **F32)


@pytest.mark.parametrize("seed", range(4))
def test_bf16_fuzz_on_gpu(seed):
    import ml_dtypes

    # allow_while=False: at bf16 a value within an ulp of a while
    # threshold can flip the iteration count, which no tolerance covers
    run_differential_case(
        seed, backends=("pallas",), dtype=np.dtype(ml_dtypes.bfloat16),
        aligned=True, rtol=0.02, atol=0.01, allow_while=False,
        max_flip_fraction=1e-4,
    )


def test_pallas_autodiff_on_gpu():
    """jax.grad through the pallas functional path: the kernel runs the
    forward, the XLA executor the tangents."""
    import jax
    import jax.numpy as jnp

    from gt4py_tpu.cartesian import gtscript
    from gt4py_tpu.cartesian.backend import pallas_backend
    from gt4py_tpu.cartesian.gtscript import PARALLEL, computation, interval

    F = gtscript.Field[np.float32]

    def defn(a: F, out: F, *, w: np.float32):
        with computation(PARALLEL), interval(...):
            out = a - w * (a[1, 0, 0] + a[-1, 0, 0] - 2.0 * a)

    shape, origin, dom = (36, 260, 8), (2, 2, 0), (32, 256, 8)
    fns = {
        be: gtscript.stencil(backend=be, name=f"gpu_ad_{be}")(defn).functional(
            origin=origin, domain=dom
        )
        for be in ("jax", "pallas")
    }
    x = jnp.asarray(np.random.default_rng(13).random(shape, dtype=np.float32))
    w0 = jnp.float32(0.2)

    def loss(fn, a, w):
        return jnp.sum(fn(a=a, out=jnp.zeros_like(a), w=w)["out"] ** 2)

    before = pallas_backend.FALLBACK_EVENTS.total
    for argnum in (0, 1):
        gj = jax.jit(jax.grad(lambda a, w: loss(fns["jax"], a, w), argnum))(x, w0)
        gp = jax.jit(jax.grad(lambda a, w: loss(fns["pallas"], a, w), argnum))(x, w0)
        np.testing.assert_allclose(np.asarray(gp), np.asarray(gj), rtol=2e-5, atol=1e-6)
    assert pallas_backend.FALLBACK_EVENTS.total == before

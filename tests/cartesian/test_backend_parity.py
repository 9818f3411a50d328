"""Backend-parity harness: every canonical stencil runs on every backend
and must match the numpy oracle (reference pattern:
tests/cartesian_tests/.../test_code_generation.py)."""

import numpy as np
import pytest

from gt4py_tpu.cartesian import gtscript

from . import stencil_defs

# kernel numerics for every stencil class, not only the default rule's
pytestmark = pytest.mark.usefixtures("all_kernel_classes")


PARITY_BACKENDS = ["jax", "pallas"]


def _run_on_backend(entry, backend):
    stencil = gtscript.stencil(
        backend=backend,
        definition=entry["definition"],
        externals=entry["externals"],
        rebuild=True,
    )
    inputs = entry["make_inputs"]()
    fields = {k: v for k, v in inputs.items() if isinstance(v, np.ndarray)}
    scalars = {k: v for k, v in inputs.items() if not isinstance(v, np.ndarray)}
    kwargs = {}
    if entry["origin"] is not None:
        kwargs["origin"] = entry["origin"]
    if entry["domain"] is not None:
        kwargs["domain"] = entry["domain"]
    stencil(**fields, **scalars, **kwargs)
    return fields


@pytest.mark.parametrize("backend", PARITY_BACKENDS)
@pytest.mark.parametrize("name", sorted(stencil_defs.REGISTRY))
def test_backend_parity(name, backend):
    entry = stencil_defs.REGISTRY[name]
    oracle = _run_on_backend(entry, "numpy")
    result = _run_on_backend(entry, backend)
    for fname in oracle:
        np.testing.assert_allclose(
            result[fname],
            oracle[fname],
            rtol=1e-12,
            atol=1e-12,
            err_msg=f"{name}.{fname} mismatch on backend {backend}",
        )


def _run_with_halo(entry, backend, halo=2):
    """Run on arrays embedded in a halo: the compute domain sits at
    origin=(halo, halo, 0) and the halo ring must remain untouched
    (regression: the scan writeback once clobbered halos with zeros)."""
    stencil = gtscript.stencil(
        backend=backend,
        definition=entry["definition"],
        externals=entry["externals"],
        rebuild=True,
    )
    inputs = entry["make_inputs"]()
    fields = {}
    rng = np.random.default_rng(99)
    for k, v in inputs.items():
        if not isinstance(v, np.ndarray):
            continue
        if v.ndim < 3:
            fields[k] = v
            continue
        padded = rng.random(
            (v.shape[0] + 2 * halo, v.shape[1] + 2 * halo) + v.shape[2:]
        ).astype(v.dtype)
        padded[halo:-halo, halo:-halo] = v
        fields[k] = padded
    scalars = {k: v for k, v in inputs.items() if not isinstance(v, np.ndarray)}
    first = next(iter(inputs.values()))
    domain = first.shape[:3]
    stencil(**fields, **scalars, origin=(halo, halo, 0), domain=domain)
    return fields


@pytest.mark.parametrize("backend", PARITY_BACKENDS)
@pytest.mark.parametrize("name", ["tridiagonal_solver", "vertical_advection_dycore",
                                  "forward_cumsum", "runtime_if_nested"])
def test_backend_parity_with_halo(name, backend):
    entry = stencil_defs.REGISTRY[name]
    oracle = _run_with_halo(entry, "numpy")
    result = _run_with_halo(entry, backend)
    for fname in oracle:
        np.testing.assert_allclose(
            result[fname],
            oracle[fname],
            rtol=1e-12,
            atol=1e-12,
            err_msg=f"{name}.{fname} halo-run mismatch on backend {backend}",
        )


def test_dycore_fused_single_kernel_matches_two_kernel():
    """models.dycore.make_dycore_fused (the SOL-table lever): the
    single-stencil form equals the hdiff -> vadv_update composition on
    the jax backend (f32 ulps; the diffused stage becomes a temp)."""
    import jax.numpy as jnp

    from gt4py_tpu.models.dycore import MiniDycore

    m = MiniDycore(16, 128, 6, dtype=np.float32, backend="jax")
    st = {k: jnp.asarray(v) for k, v in m.init_state(seed=3).items()}
    out2 = m.step_fn()(dict(st))
    out1 = m.step_fn(fused=True)(dict(st))
    for k in ("u", "utens_stage"):
        np.testing.assert_allclose(
            np.asarray(out1[k]),
            np.asarray(out2[k]),
            rtol=3e-6,
            atol=3e-6,
            err_msg=k,
        )

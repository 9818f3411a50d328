"""Differential fuzzing of the field-view DSL: random operators run on
numpy-backed vs jax-backed Fields through the shared typed-IR
interpreter (the next analog of tests/cartesian/test_fuzz_differential)."""

import pytest

from gt4py_tpu.testing.next_fuzz import run_differential_case

# kernel numerics for every stencil class, not only the default rule's
pytestmark = pytest.mark.usefixtures("all_kernel_classes")


@pytest.mark.parametrize("seed", range(60))
def test_random_field_operator_parity(seed):
    run_differential_case(seed)


@pytest.mark.parametrize("seed", range(60, 75))
def test_random_field_operator_jit_vmap_invariance(seed):
    """The jax path under jit and vmap must match the numpy oracle."""
    run_differential_case(seed, transforms=True)


@pytest.mark.parametrize("seed", range(20))
def test_random_field_operator_bf16(seed):
    """bfloat16 leg: the same generated operators with bf16 fields and
    scalars.  Exercises weak-literal adaptation into bf16 (incl. weak
    fields from where() of literals) and bf16 reductions."""
    import ml_dtypes

    run_differential_case(seed, dtype=ml_dtypes.bfloat16, rtol=0.02, atol=0.01)


@pytest.mark.parametrize("seed", range(40))
def test_random_program_parity(seed):
    """Random PROGRAMS (multi-statement, sliced/plain outs, domain= dict
    literals): numpy-oracle backend vs embedded-jax vs the jit/AOT pool."""
    from gt4py_tpu.testing.next_fuzz import run_program_case

    run_program_case(seed)


def test_fuzz_regression_weak_result_into_out():
    """Sweep-found (seed 2411): a tuple operator whose member expression
    is all-literal (weak dtype) was rejected when written into a typed
    out= target -- weak results must adapt to the out dtype."""
    from gt4py_tpu.testing.next_fuzz import run_program_case

    run_program_case(2411)


def test_static_param_not_trailing():
    """AOT pool with a static parameter in the MIDDLE of the signature:
    the pool functional publishes (dynamic-positional, static-keyword-only)
    so jit's static_argnames binding is order-independent."""
    import numpy as np

    import gt4py_tpu.next as gtx
    from gt4py_tpu.next import Dims, Field, backends

    I = gtx.Dimension("I")

    @gtx.field_operator
    def scale(a: Field[Dims[I], gtx.float64], n: gtx.int64) -> Field[Dims[I], gtx.float64]:
        return a * gtx.astype(n, gtx.float64)

    @gtx.program
    def prog(a: Field[Dims[I], gtx.float64], n: gtx.int64, out: Field[Dims[I], gtx.float64]):
        scale(a, n, out=out)

    a = gtx.as_field((I,), np.arange(4.0))
    o = gtx.as_field((I,), np.zeros(4))
    pj = prog.with_backend(backends.jax_jit).with_static_params("n")
    pj(a, np.int64(3), o)
    np.testing.assert_array_equal(np.asarray(o.ndarray), np.arange(4.0) * 3)
    pj(a, np.int64(5), o)
    np.testing.assert_array_equal(np.asarray(o.ndarray), np.arange(4.0) * 5)


@pytest.mark.parametrize("seed", range(40))
def test_random_pallas_bridge_parity(seed):
    """The pallas bridge (kernel lowering OR transparent fallback) vs the
    numpy oracle: generated field operators with helper calls and tuple
    returns, plus scan operators with scalar/tuple carries."""
    from gt4py_tpu.testing.next_fuzz import run_bridge_case

    run_bridge_case(seed)


def test_pallas_bridge_fuzz_lowering_rate():
    """A minimum fraction of generated cases must actually LOWER to
    kernel plans -- otherwise the differential leg silently degrades into
    fallback-only coverage."""
    from gt4py_tpu.testing.next_fuzz import run_bridge_case

    lowered = sum(run_bridge_case(s) for s in range(40))
    assert lowered >= 16, f"only {lowered}/40 cases lowered to kernels"

"""Hypothesis-driven stencil suites (reference pattern:
tests/cartesian_tests/integration_tests/multi_feature_tests/test_suites.py)."""

import pytest
import numpy as np

from gt4py_tpu import testing as gt_testing
from gt4py_tpu.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    computation,
    interval,
    __INLINED,
)

# kernel numerics for every stencil class, not only the default rule's
pytestmark = pytest.mark.usefixtures("all_kernel_classes")


class TestCopy(gt_testing.StencilTestSuite):
    dtypes = (np.float64, np.float32)
    domain_range = [(1, 15), (1, 15), (1, 8)]
    backends = ["numpy", "jax"]
    symbols = dict(
        field_a=gt_testing.field(in_range=(-10, 10)),
        field_b=gt_testing.field(in_range=(-10, 10)),
    )

    def definition(field_a, field_b):
        with computation(PARALLEL), interval(...):
            field_b = field_a

    def validation(field_a, field_b, domain=None, origin=None, externals=None):
        field_b[...] = field_a


class TestAvgOffsets(gt_testing.StencilTestSuite):
    dtypes = (np.float64,)
    domain_range = [(2, 12), (2, 12), (1, 6)]
    backends = ["numpy", "jax"]
    symbols = dict(
        inp=gt_testing.field(in_range=(-10, 10), boundary=[(1, 1), (1, 1), (0, 0)]),
        out=gt_testing.field(in_range=(-10, 10)),
        w=gt_testing.parameter(in_range=(0.1, 2.0)),
    )

    def definition(inp, out, *, w):
        with computation(PARALLEL), interval(...):
            out = w * (inp[-1, 0, 0] + inp[1, 0, 0] + inp[0, -1, 0] + inp[0, 1, 0])

    def validation(inp, out, *, w, domain=None, origin=None, externals=None):
        oi, oj, _ = origin["inp"]
        dI, dJ, dK = domain
        interior = lambda di, dj: inp[
            oi + di : oi + di + dI, oj + dj : oj + dj + dJ, :
        ]
        out[
            origin["out"][0] : origin["out"][0] + dI,
            origin["out"][1] : origin["out"][1] + dJ,
        ] = w * (interior(-1, 0) + interior(1, 0) + interior(0, -1) + interior(0, 1))


class TestForwardAccumulate(gt_testing.StencilTestSuite):
    dtypes = (np.float64,)
    domain_range = [(1, 8), (1, 8), (2, 10)]
    min_k_size = 2
    backends = ["numpy", "jax"]
    symbols = dict(
        inp=gt_testing.field(in_range=(-5, 5)),
        acc=gt_testing.field(in_range=(-5, 5)),
    )

    def definition(inp, acc):
        with computation(FORWARD):
            with interval(0, 1):
                acc = inp
            with interval(1, None):
                acc = acc[0, 0, -1] + inp

    def validation(inp, acc, domain=None, origin=None, externals=None):
        acc[...] = np.cumsum(inp, axis=2)


class TestExternalSwitch(gt_testing.StencilTestSuite):
    dtypes = (np.float64,)
    domain_range = [(1, 10), (1, 10), (1, 5)]
    backends = ["numpy", "jax"]
    symbols = dict(
        inp=gt_testing.field(in_range=(-10, 10)),
        out=gt_testing.field(in_range=(-10, 10)),
        NEGATE=gt_testing.global_name(one_of=(True, False)),
    )

    def definition(inp, out):
        from __externals__ import NEGATE

        with computation(PARALLEL), interval(...):
            if __INLINED(NEGATE):
                out = -inp
            else:
                out = inp

    def validation(inp, out, domain=None, origin=None, externals=None):
        out[...] = -inp if externals["NEGATE"] else inp


class TestMatmul(gt_testing.StencilTestSuite):
    """`matrix @ vector` + `.T` on data-dims fields (reference:
    TestMatmul in tests/.../test_suites.py:1097; parser MatMult at
    gtscript_frontend.py:1506, unroll at defir_to_gtir.py:265-273).
    f64 only: the unrolled left-to-right multiply-add chain differs
    from einsum's reduction order at f32 (same note in the reference)."""

    dtypes = (np.float64,)
    domain_range = [(2, 6), (2, 6), (2, 4)]
    backends = ["numpy", "jax", "pallas"]
    symbols = dict(
        matrix=gt_testing.field(in_range=(-10, 10), data_dims=(4, 6)),
        field_1=gt_testing.field(in_range=(-10, 10), data_dims=(6,)),
        field_2=gt_testing.field(in_range=(-10, 10), data_dims=(4,)),
    )

    def definition(matrix, field_1, field_2):
        with computation(PARALLEL):
            with interval(0, 1):
                field_2 = matrix @ field_1
            with interval(1, 2):
                field_1 = matrix.T @ field_2

    def validation(
        matrix, field_1, field_2, domain=None, origin=None, externals=None
    ):
        field_2[:, :, 0] = np.einsum(
            "ijlm,ijm->ijl", matrix[:, :, 0], field_1[:, :, 0]
        )
        field_1[:, :, 1] = np.einsum(
            "ijlm,ijl->ijm", matrix[:, :, 1], field_2[:, :, 1]
        )

"""bfloat16 in the next field-view DSL (an extension; the reference scalar
table stops at f32/f64).  Type deduction treats bf16 as arithmetic (its
numpy kind is 'V'), mixed concrete dtypes are still rejected, and
execution runs natively on the jax-embedded Field."""

import ml_dtypes
import numpy as np
import pytest

import gt4py_tpu.next as gtx
from gt4py_tpu.next import (
    Dimension,
    DimensionKind,
    Dims,
    Field,
    as_field,
    bfloat16,
    field_operator,
    scan_operator,
)
from gt4py_tpu.next.frontend import FieldViewError
from gt4py_tpu.next import type_system as ts

I = Dimension("I")
J = Dimension("J")
K = Dimension("K", kind=DimensionKind.VERTICAL)

BFField = Field[Dims[I, J], bfloat16]


def _bf(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(ml_dtypes.bfloat16)


def test_bf16_is_arithmetic_type():
    t = ts.ScalarType(np.dtype(ml_dtypes.bfloat16))
    assert ts.is_arithmetic(t)
    assert not ts.is_logical(t)
    assert not ts.is_integral(t)


def test_bf16_field_operator_executes():
    @field_operator
    def fo(a: BFField, b: BFField) -> BFField:
        return a * b + a

    a = as_field((I, J), _bf(0, (5, 6)))
    b = as_field((I, J), _bf(1, (5, 6)))
    out = fo(a, b)
    assert np.dtype(out.dtype) == np.dtype(ml_dtypes.bfloat16)
    expect = np.asarray(a.data) * np.asarray(b.data) + np.asarray(a.data)
    np.testing.assert_array_equal(
        np.asarray(out.data, np.float32), np.asarray(expect, np.float32)
    )


def test_bf16_float_literal_adapts():
    @field_operator
    def fo(a: BFField) -> BFField:
        return a * 2.0 + 0.5

    a = as_field((I, J), _bf(2, (4, 4)))
    out = fo(a)
    assert np.dtype(out.dtype) == np.dtype(ml_dtypes.bfloat16)


def test_bf16_mixed_concrete_dtypes_rejected():
    with pytest.raises(FieldViewError, match="could not promote"):

        @field_operator
        def bad(a: BFField, b: Field[Dims[I, J], np.float32]) -> BFField:
            return a + b


def test_bf16_scan_operator():
    @scan_operator(axis=K, forward=True, init=bfloat16(0.0))
    def cumsum(carry: bfloat16, x: bfloat16) -> bfloat16:
        return carry + x

    x = as_field((K,), _bf(3, (8,)))
    out = cumsum(x)
    assert np.dtype(out.dtype) == np.dtype(ml_dtypes.bfloat16)
    # bitwise: both accumulate in bf16 step order
    expect = np.zeros(8, dtype=ml_dtypes.bfloat16)
    acc = ml_dtypes.bfloat16(0.0)
    for i, v in enumerate(np.asarray(x.data)):
        acc = ml_dtypes.bfloat16(acc + v)
        expect[i] = acc
    np.testing.assert_array_equal(
        np.asarray(out.data, np.float32), expect.astype(np.float32)
    )


def test_bf16_weak_field_from_where_adapts():
    """where() of two literals over a field condition produces a WEAK
    field (jax-style): combining it with a bf16 field stays bf16 instead
    of erroring on a concrete f64."""
    from gt4py_tpu.next import where

    @field_operator
    def fo(a: BFField) -> BFField:
        sel = where(a > 0.5, 1.0, 0.25)
        return a * sel

    a = as_field((I, J), _bf(7, (4, 5)))
    out = fo(a)
    assert np.dtype(out.dtype) == np.dtype(ml_dtypes.bfloat16)
    an = np.asarray(a.data, np.float32)
    expect = an * np.where(an > 0.5, 1.0, 0.25).astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(out.data, np.float32), expect.astype(ml_dtypes.bfloat16).astype(np.float32))


def test_bf16_astype_boundary():
    @field_operator
    def fo(a: Field[Dims[I, J], np.float32]) -> BFField:
        return gtx.astype(a, bfloat16)

    a = as_field((I, J), np.random.default_rng(4).random((3, 3), dtype=np.float32))
    out = fo(a)
    assert np.dtype(out.dtype) == np.dtype(ml_dtypes.bfloat16)

"""bfloat16 as a first-class stencil dtype (an extension; the
reference has no sub-f32 float support — its dtype table stops at f32/f64).

Numerics contract:
- pure-arithmetic bf16 stencils match the numpy oracle BITWISE on CPU
  (both ml_dtypes-numpy and XLA-CPU round each op from f32);
- transcendentals may differ by a few bf16 ulps: the oracle computes at
  higher precision (f64 scipy) and rounds once — correctly rounded —
  while XLA upcasts to f32 per op;
- mixed-precision expressions follow C-style promotion (bf16 < f32 < f64,
  bf16+f16 -> f32) with a single cast back at assignment.
"""

import ml_dtypes
import numpy as np
import pytest

from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.analysis import BFLOAT16, is_float_dtype, promote_dtypes
from gt4py_tpu.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    bfloat16,
    computation,
    erf,
    exp,
    gamma,
    interval,
    mod,
    sin,
    sqrt,
)

# kernel numerics for every stencil class, not only the default rule's
pytestmark = pytest.mark.usefixtures("all_kernel_classes")

FieldBF = gtscript.Field[bfloat16]
Field32 = gtscript.Field[np.float32]

BACKENDS = ["jax", "pallas"]


def _mk(seed, shape, dtype=bfloat16):
    rng = np.random.default_rng(seed)
    return rng.random(shape).astype(dtype)


# --------------------------------------------------------------------------- #
# promotion rules
# --------------------------------------------------------------------------- #


def test_promote_dtypes_bfloat16():
    assert promote_dtypes(BFLOAT16, np.dtype(np.float32)) == np.dtype(np.float32)
    assert promote_dtypes(BFLOAT16, np.dtype(np.float64)) == np.dtype(np.float64)
    assert promote_dtypes(BFLOAT16, np.dtype(np.int32)) == BFLOAT16
    assert promote_dtypes(BFLOAT16, BFLOAT16) == BFLOAT16
    # f16 vs bf16: neither holds the other -> f32 (numpy/jax lattice rule)
    assert promote_dtypes(BFLOAT16, np.dtype(np.float16)) == np.dtype(np.float32)
    assert promote_dtypes(np.dtype(np.float16), BFLOAT16) == np.dtype(np.float32)


def test_is_float_dtype():
    assert is_float_dtype(BFLOAT16)  # numpy kind is 'V', not 'f'
    assert is_float_dtype(np.float32)
    assert not is_float_dtype(np.int32)
    assert not is_float_dtype(np.bool_)


# --------------------------------------------------------------------------- #
# backend parity
# --------------------------------------------------------------------------- #


def _run(defn, backend, fields, scalars=None, origin=(0, 0, 0), domain=None):
    st = gtscript.stencil(backend=backend, name=f"{defn.__name__}_{backend}")(defn)
    arrs = {k: v.copy() for k, v in fields.items()}
    st(**arrs, **(scalars or {}), origin=origin, domain=domain or fields["inp"].shape)
    return {k: np.asarray(v, dtype=np.float64) for k, v in arrs.items()}


def defn_arith(inp: FieldBF, out: FieldBF, *, w: bfloat16):
    with computation(PARALLEL), interval(...):
        lap = inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0]
        out = inp - w * (lap - 4.0 * inp)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_arith_parity_bitwise(backend):
    fields = {"inp": _mk(0, (10, 10, 4)), "out": np.zeros((10, 10, 4), dtype=bfloat16)}
    sc = {"w": bfloat16(0.1)}
    ora = _run(defn_arith, "numpy", fields, sc, origin=(1, 1, 0), domain=(8, 8, 4))
    res = _run(defn_arith, backend, fields, sc, origin=(1, 1, 0), domain=(8, 8, 4))
    np.testing.assert_array_equal(res["out"], ora["out"])
    assert np.abs(ora["out"]).max() > 0


def defn_scan(inp: FieldBF, out: FieldBF):
    with computation(FORWARD):
        with interval(0, 1):
            out = inp
        with interval(1, None):
            out = out[0, 0, -1] + inp


def defn_backward(inp: FieldBF, out: FieldBF):
    with computation(BACKWARD):
        with interval(-1, None):
            out = inp
        with interval(0, -1):
            out = out[0, 0, 1] * 0.5 + inp


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("defn", [defn_scan, defn_backward])
def test_bf16_scan_parity_bitwise(backend, defn):
    fields = {"inp": _mk(1, (6, 6, 8)), "out": np.zeros((6, 6, 8), dtype=bfloat16)}
    ora = _run(defn, "numpy", fields)
    res = _run(defn, backend, fields)
    np.testing.assert_array_equal(res["out"], ora["out"])


def defn_natives(inp: FieldBF, out: FieldBF):
    with computation(PARALLEL), interval(...):
        out = erf(inp) + sin(inp) + sqrt(inp) + exp(inp) + mod(inp, 1.5) + gamma(inp)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_transcendentals_few_ulps(backend):
    fields = {
        "inp": (0.5 + _mk(2, (8, 8, 3)).astype(np.float64)).astype(bfloat16),
        "out": np.zeros((8, 8, 3), dtype=bfloat16),
    }
    ora = _run(defn_natives, "numpy", fields)
    res = _run(defn_natives, backend, fields)
    # oracle rounds once from f64; XLA computes per-op via f32: allow a
    # couple of bf16 ulps (2^-8 relative each)
    np.testing.assert_allclose(res["out"], ora["out"], rtol=2 ** -6, atol=2 ** -6)


def test_bf16_native_result_dtype_discipline():
    """mod/erf/gamma on bf16 stay bf16 in the oracle (numpy/scipy would
    upcast to f32/f64): the written field receives a value rounded exactly
    once from the high-precision result."""
    from gt4py_tpu.cartesian import gtscript as gts

    def defn(inp: FieldBF, out: FieldBF):
        with computation(PARALLEL), interval(...):
            out = mod(inp, 1.5)

    st = gts.stencil(backend="numpy", name="bf16_mod_dtype")(defn)
    inp = _mk(3, (4, 4, 2))
    out = np.zeros_like(inp)
    st(inp, out)
    assert out.dtype == BFLOAT16
    expect = np.mod(inp.astype(np.float64), 1.5).astype(bfloat16)
    np.testing.assert_array_equal(out, expect)


def defn_mixed(inp: FieldBF, coef: Field32, out: FieldBF):
    with computation(PARALLEL), interval(...):
        out = inp * coef + 1.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_mixed_precision_parity(backend):
    fields = {
        "inp": _mk(4, (8, 8, 3)),
        "coef": _mk(5, (8, 8, 3), np.float32),
        "out": np.zeros((8, 8, 3), dtype=bfloat16),
    }
    ora = _run(defn_mixed, "numpy", fields)
    res = _run(defn_mixed, backend, fields)
    np.testing.assert_array_equal(res["out"], ora["out"])


def test_bf16_storage_and_arg_validation():
    from gt4py_tpu import storage
    from gt4py_tpu.cartesian.stencil_object import ArgumentError

    z = storage.zeros((4, 4, 2), dtype=bfloat16, backend="numpy")
    assert z.dtype == BFLOAT16
    f = storage.from_array(np.ones((4, 4, 2)), dtype=bfloat16, backend="numpy")
    assert f.dtype == BFLOAT16

    st = gtscript.stencil(backend="numpy", name="bf16_argcheck")(defn_scan)
    wrong = np.zeros((4, 4, 2), dtype=np.float32)
    with pytest.raises(ArgumentError, match="bfloat16"):
        st(wrong, np.zeros((4, 4, 2), dtype=bfloat16))


@pytest.mark.parametrize("backend", BACKENDS)
def test_f16_arith_parity_bitwise(backend):
    """float16 rides the same sub-f32 machinery as bfloat16 (its numpy
    kind IS 'f', so it exercises the non-'V' half of the code paths)."""
    Field16 = gtscript.Field[np.float16]

    def defn_f16(inp: Field16, out: Field16):
        with computation(PARALLEL), interval(...):
            out = inp[1, 0, 0] + inp[-1, 0, 0] - 2.0 * inp

    fields = {
        "inp": _mk(8, (8, 8, 3), np.float16),
        "out": np.zeros((8, 8, 3), dtype=np.float16),
    }
    ora = _run(defn_f16, "numpy", fields, origin=(1, 0, 0), domain=(6, 8, 3))
    res = _run(defn_f16, backend, fields, origin=(1, 0, 0), domain=(6, 8, 3))
    np.testing.assert_array_equal(res["out"], ora["out"])


def test_dtypes_mapping_to_bfloat16():
    """``dtypes={float: bfloat16}``: stencils written against generic
    ``float`` annotations rebind to bf16 at build time (reference
    dtypes= mechanism, gtscript.py stencil kwargs)."""

    def defn(inp: gtscript.Field[float], out: gtscript.Field[float]):
        with computation(PARALLEL), interval(...):
            out = inp * 2.0

    st = gtscript.stencil(
        backend="numpy", name="bf16_dtypes_map", dtypes={float: bfloat16}
    )(defn)
    inp = _mk(9, (4, 4, 2))
    out = np.zeros_like(inp)
    st(inp, out)
    assert out.dtype == BFLOAT16
    np.testing.assert_array_equal(out, (inp.astype(np.float32) * 2.0).astype(bfloat16))


def test_bf16_pallas_falls_back_on_chip_geometry():
    """bf16 stencils run through the pallas backend (kernel or visible
    fallback, never a crash); the card runs the bf16 fuzz legs."""
    from gt4py_tpu.cartesian.backend.pallas_backend import PallasBackend

    st = gtscript.stencil(backend="pallas", name="bf16_gate")(defn_arith)
    backend = st._backend if hasattr(st, "_backend") else None
    # the gate is an implementation detail; the contract is: running works
    inp = _mk(6, (10, 10, 4))
    out = np.zeros_like(inp)
    st(inp, out, w=bfloat16(0.1), origin=(1, 1, 0), domain=(8, 8, 4))
    assert np.abs(np.asarray(out, dtype=np.float64)).max() > 0


# --------------------------------------------------------------------------- #
# storage-format semantics (r4): statements compute in f32
# --------------------------------------------------------------------------- #


def test_f16_storage_semantics_statement_accumulation():
    """bf16 statements accumulate in f32 and round ONCE per store: the
    result equals the f32 computation rounded at the end, not the
    per-op-rounded chain (passes.widen_f16_compute, all backends)."""

    def chain(inp: FieldBF, out: FieldBF):
        with computation(PARALLEL), interval(...):
            out = ((inp + 0.001) + 0.001) + 0.001

    inp = _mk(7, (4, 4, 2))
    expect_stmt_f32 = (
        ((inp.astype(np.float32) + np.float32(0.001)) + np.float32(0.001))
        + np.float32(0.001)
    ).astype(bfloat16)
    per_op = ((inp + bfloat16(0.001)) + bfloat16(0.001)) + bfloat16(0.001)
    assert not np.array_equal(
        expect_stmt_f32.astype(np.float64), per_op.astype(np.float64)
    ), "test data must distinguish the two semantics"
    for backend in BACKENDS:
        res = _run(chain, backend, {"inp": inp, "out": np.zeros_like(inp)})
        np.testing.assert_array_equal(
            res["out"], expect_stmt_f32.astype(np.float64), err_msg=backend
        )


def test_f16_storage_semantics_explicit_astype_rounds():
    """An explicit astype to bf16 mid-statement is a preserved rounding
    point (then computation continues in f32)."""
    import gt4py_tpu.cartesian.gtscript as gts

    def defn(inp: FieldBF, out: FieldBF):
        with computation(PARALLEL), interval(...):
            t = inp * 1.001
            out = t + inp

    inp = _mk(8, (4, 4, 2))
    # t is an f32 temp under storage semantics: NO bf16 rounding of t
    expect = (
        inp.astype(np.float32) * np.float32(1.001) + inp.astype(np.float32)
    ).astype(bfloat16)
    res = _run(defn, "numpy", {"inp": inp, "out": np.zeros_like(inp)})
    np.testing.assert_array_equal(res["out"], expect.astype(np.float64))

"""Block planning of the column kernel (``pallas_backend.plan_blocks``)
and 16-bit / mixed-dtype stencils through it.

Blocks are powers of two, J rows of 256 bytes at 4-byte types (two
128-byte transactions), at most 512 points; ragged domains are masked.
"""

import ml_dtypes
import numpy as np
import pytest

from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.backend import pallas_backend
from gt4py_tpu.cartesian.backend.pallas_backend import BlockPlan, plan_blocks
from gt4py_tpu.cartesian.gtscript import PARALLEL, bfloat16, computation, interval

BF16 = np.dtype(ml_dtypes.bfloat16)
FieldBF = gtscript.Field[bfloat16]
Field32 = gtscript.Field[np.float32]

pytestmark = pytest.mark.usefixtures("all_kernel_classes")


def _pow2(n):
    return n > 0 and n & (n - 1) == 0


def test_sublane_by_dtype():
    """Row width by element size: 64 points up to 4 bytes, 32 at 8."""
    assert plan_blocks(512, 512, 4).bj == 64
    assert plan_blocks(512, 512, 2).bj == 64
    assert plan_blocks(512, 512, 8).bj == 32
    assert plan_blocks(512, 512, 4) == BlockPlan(8, 64, 4, 2)


def test_pad_tile_respects_packing():
    """Ragged sizes get power-of-two blocks no larger than needed."""
    for n in (1, 3, 7, 33, 130):
        b = plan_blocks(n, n)
        assert _pow2(b.bi) and _pow2(b.bj)
        assert b.bi * b.bj <= 512
        assert b.bj < 2 * n and b.bi < 2 * max(n, 1)


def _run(defn, dtype, shape, name, out_dtype=None):
    res = {}
    rng = np.random.default_rng(0)
    a0 = rng.random(shape).astype(dtype)
    for be in ("numpy", "pallas"):
        st = gtscript.stencil(backend=be, name=f"{name}_{be}")(defn)
        out = np.zeros(shape, out_dtype or dtype)
        before = pallas_backend.FALLBACK_EVENTS.total
        st(a0.copy(), out, origin=(2, 2, 0),
           domain=(shape[0] - 4, shape[1] - 4, shape[2]))
        if be == "pallas":
            assert pallas_backend.FALLBACK_EVENTS.total == before
            plan = pallas_backend.LAST_PLAN[f"{name}_{be}"]
        res[be] = out.astype(np.float64)
    return res, plan


def test_bf16_halos_align_to_16():
    """bf16 through the kernel: the 2-wide read halo on both sides."""

    def defn(inp: FieldBF, out: FieldBF):
        with computation(PARALLEL), interval(...):
            out = inp[1, 0, 0] + inp[-2, 0, 0]

    res, _ = _run(defn, BF16, (20, 70, 3), "bf16_halo")
    np.testing.assert_allclose(res["pallas"], res["numpy"], rtol=1e-2)


def test_bf16_row_plan_tiles_are_16_multiples():
    """A bf16 stencil plans 64-wide J rows like f32."""

    def defn(inp: FieldBF, out: FieldBF):
        with computation(PARALLEL), interval(...):
            out = inp[0, 1, 0] * 0.5

    res, plan = _run(defn, BF16, (20, 140, 3), "bf16_rows")
    assert plan["blocks"] == [(8, 64)], plan
    np.testing.assert_allclose(res["pallas"], res["numpy"], rtol=1e-2)


def test_mixed_f32_bf16_uses_strictest_packing():
    """Mixed bf16 / f64 fields plan by the widest element (8 bytes)."""
    F64 = gtscript.Field[np.float64]

    def defn(inp: FieldBF, out: F64):
        with computation(PARALLEL), interval(...):
            out = inp[1, 0, 0] + 1.0

    res, plan = _run(defn, BF16, (20, 70, 3), "mixed_width", np.float64)
    assert plan["blocks"] == [(16, 32)], plan
    np.testing.assert_allclose(res["pallas"], res["numpy"], rtol=1e-2)


def test_f32_plans_unchanged_by_packing_awareness():
    """f32: 8 x 64 blocks at the bench shape, exact parity."""

    def defn(inp: Field32, out: Field32):
        with computation(PARALLEL), interval(...):
            out = inp[1, 0, 0] - inp[0, -1, 0]

    res, plan = _run(defn, np.float32, (20, 70, 3), "f32_plan")
    assert plan["blocks"] == [(8, 64)], plan
    np.testing.assert_array_equal(res["pallas"], res["numpy"])

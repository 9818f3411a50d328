"""Periodic I/J through the pallas column kernel.

Periodic axes fill each read field's halo from the opposite interior edge
before the kernel runs (the same semantics as the other executors), so
the kernel sees ordinary halo-extended buffers.  These tests pin (a) that
the kernel actually ran (via LAST_PLAN -- matching results alone cannot
distinguish the paths), (b) bitwise oracle parity for the constructs that
interact with the wrap (regions, axis positions, serial K), and (c) the
multi-block grid with small forced blocks.
"""

import numpy as np
import pytest

from gt4py_tpu import storage
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.backend import pallas_backend
from gt4py_tpu.cartesian.gtscript import (
    FORWARD,
    I,
    J,
    PARALLEL,
    computation,
    horizontal,
    interval,
    region,
)

F = gtscript.Field[np.float64]

pytestmark = pytest.mark.usefixtures("all_kernel_classes")

NI, NJ, NK = 24, 16, 5
H = 2
SHAPE = (NI + 2 * H, NJ + 2 * H, NK)
INTERIOR = (slice(H, H + NI), slice(H, H + NJ), slice(None))


def _oracle(defn, a0, periodic=("I", "J")):
    st = gtscript.stencil(backend="numpy")(defn)
    af = storage.from_array(a0.copy(), backend="numpy", aligned_index=(H, H, 0))
    bf = storage.zeros(SHAPE, backend="numpy", aligned_index=(H, H, 0))
    st(af, bf, domain=(NI, NJ, NK), periodic=periodic)
    return np.asarray(bf)


def _run_pallas(defn, a0, name, periodic=("I", "J")):
    st = gtscript.stencil(backend="pallas", name=name)(defn)
    a = storage.from_array(a0.copy(), backend="numpy", aligned_index=(H, H, 0))
    b = storage.zeros(SHAPE, backend="numpy", aligned_index=(H, H, 0))
    st(a, b, domain=(NI, NJ, NK), periodic=periodic)
    return np.asarray(b)


def _small_blocks(monkeypatch):
    """Force 4 x 8 blocks: many programs per grid, ragged edges."""
    monkeypatch.setattr(
        pallas_backend, "plan_blocks",
        lambda ni, nj, itemsize=4: pallas_backend.BlockPlan(4, 8, 1, 2),
    )


def _check(defn, name, seed, periodic=("I", "J")):
    a0 = np.random.default_rng(seed).random(SHAPE)
    got = _run_pallas(defn, a0, name, periodic)
    assert name in pallas_backend.LAST_PLAN, "the kernel did not run"
    expect = _oracle(defn, a0, periodic)
    assert np.array_equal(got[INTERIOR], expect[INTERIOR])
    return pallas_backend.LAST_PLAN[name]


def test_circular_engages_and_matches_oracle():
    def two_stage(a: F, b: F):
        with computation(PARALLEL), interval(...):
            tmp = a[0, 1, 0] + a[0, -1, 0] + a[1, 0, 0]
            b = tmp[0, -1, 0] + tmp[0, 1, 0] + tmp[-1, 0, 0]

    _check(two_stage, "circ_two_stage", 11)


def test_region_disables_circular():
    def with_region(a: F, b: F):
        with computation(PARALLEL), interval(...):
            tmp = a[0, 1, 0] + a[0, -1, 0]
            b = tmp[0, 1, 0]
            with horizontal(region[I[0] : I[0] + 2, J[0] : J[0] + 2]):
                b = 0.0

    _check(with_region, "circ_region", 12)


def test_axis_position_j_disables_circular():
    def with_jpos(a: F, b: F):
        with computation(PARALLEL), interval(...):
            tmp = a[0, 1, 0] + J
            b = tmp[0, 1, 0] + tmp[0, -1, 0]

    _check(with_jpos, "circ_jpos", 13)


def test_axis_position_i_keeps_circular():
    def with_ipos(a: F, b: F):
        with computation(PARALLEL), interval(...):
            tmp = a[0, 1, 0] + I
            b = tmp[0, 1, 0] + tmp[0, -1, 0]

    _check(with_ipos, "circ_ipos", 14)


def test_serial_k_is_not_circular():
    """A FORWARD sweep under periodic J: the K-cache carries b."""

    def serial(a: F, b: F):
        with computation(FORWARD):
            with interval(0, 1):
                b = a[0, 1, 0]
            with interval(1, None):
                b = b[0, 0, -1] + a[0, -1, 0]

    plan = _check(serial, "circ_serial", 15)
    assert plan["carries"] == ["b"], plan


def test_periodic_i_only_is_not_circular():
    def lap(a: F, b: F):
        with computation(PARALLEL), interval(...):
            b = a[1, 0, 0] + a[-1, 0, 0]

    _check(lap, "circ_i_only", 16, periodic=("I",))


def test_halo_wider_than_domain_matches_oracle_error():
    """dJ < read halo: the oracle raises; the kernel must not silently wrap."""

    def wide(a: F, b: F):
        with computation(PARALLEL), interval(...):
            b = a[0, 3, 0] + a[0, -3, 0]

    shape = (10, 8, 3)
    st = gtscript.stencil(backend="pallas", name="circ_wide")(wide)
    a = storage.from_array(
        np.random.default_rng(17).random(shape), backend="numpy",
        aligned_index=(3, 3, 0),
    )
    b = storage.zeros(shape, backend="numpy", aligned_index=(3, 3, 0))
    with pytest.raises(ValueError, match="periodic J domain"):
        st(a, b, domain=(4, 2, 3), periodic=("J",))


def test_single_slot_execution(monkeypatch):
    """Many small blocks, ragged at both edges: identical results."""

    def two_stage(a: F, b: F):
        with computation(PARALLEL), interval(...):
            tmp = a[0, 1, 0] + a[0, -1, 0] + a[1, 0, 0]
            b = tmp[0, -1, 0] + tmp[0, 1, 0] + tmp[-1, 0, 0]

    _small_blocks(monkeypatch)
    plan = _check(two_stage, "circ_1slot", 21)
    assert plan["blocks"] == [(4, 8)] * plan["stages"], plan


def test_single_slot_serial_k(monkeypatch):
    """Serial K over many small blocks."""

    def serial(a: F, b: F):
        with computation(FORWARD):
            with interval(0, 1):
                b = a[0, 1, 0]
            with interval(1, None):
                b = b[0, 0, -1] + a[0, -1, 0]

    _small_blocks(monkeypatch)
    plan = _check(serial, "circ_1slot_serial", 22)
    assert plan["blocks"] == [(4, 8)], plan


def test_planner_single_slot_fallback():
    """The default block plan of this geometry: powers of two, no larger
    than the domain needs, J the long side."""

    def lap(a: F, b: F):
        with computation(PARALLEL), interval(...):
            b = a[1, 0, 0] + a[0, 1, 0]

    plan = _check(lap, "circ_planner", 23)
    (bi, bj), = plan["blocks"]
    assert (bi, bj) == (32, 16), plan

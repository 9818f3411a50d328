"""Differential fuzzing: random IR programs, numpy oracle vs jax executor
(and the pallas interpret-mode kernel path on a subset)."""

import numpy as np
import pytest

from gt4py_tpu.testing.program_gen import run_differential_case

# kernel numerics for every stencil class, not only the default rule's
pytestmark = pytest.mark.usefixtures("all_kernel_classes")


@pytest.mark.parametrize("seed", range(100))
def test_random_program_backend_parity(seed):
    run_differential_case(seed)


@pytest.mark.parametrize("seed", range(40))
def test_random_program_pallas_parity(seed):
    run_differential_case(seed, backends=("pallas",))


@pytest.mark.parametrize("seed", range(12))
def test_random_program_pallas_f32_aligned(seed):
    """The f32 wide-geometry leg (several blocks per row; interpret mode
    on the CPU, the same cases run on the card via tests/test_gpu.py)."""
    run_differential_case(
        seed,
        backends=("pallas",),
        dtype=np.float32,
        aligned=True,
        rtol=3e-5,
        atol=3e-6,
    )


@pytest.mark.parametrize("seed", range(20))
def test_random_program_serialized_parity(seed):
    """PARALLEL->FORWARD serialization (passes.serialize_parallel_k):
    every mixed random program must stay at oracle parity when its
    parallel loops evaluate plane-by-plane."""
    run_differential_case(seed + 50000, backends=("pallas",), serialize=True)


@pytest.mark.parametrize("seed", range(4))
def test_random_program_serialized_bf16(seed):
    """Serialization x bf16 on the wide geometry."""
    import ml_dtypes

    run_differential_case(
        serialize=True,
        seed=seed + 70000,
        backends=("pallas",),
        dtype=np.dtype(ml_dtypes.bfloat16),
        aligned=True,
        rtol=3e-2,
        atol=3e-2,
        allow_while=False,
    )


@pytest.mark.parametrize("seed", range(8))
def test_random_program_serialized_f32_aligned(seed):
    run_differential_case(
        seed + 51000,
        serialize=True,
        backends=("pallas",),
        dtype=np.float32,
        aligned=True,
        rtol=3e-5,
        atol=3e-6,
    )


@pytest.mark.parametrize("seed", range(20))
def test_random_program_bf16_parity(seed):
    """bfloat16 leg: random programs in bf16 on jax + the interpret-mode
    kernel path.  Pure arithmetic matches the oracle bitwise; the
    tolerance covers transcendental chains (the oracle rounds once from
    f64, XLA upcasts per op) and bf16 scan accumulation."""
    import ml_dtypes

    run_differential_case(
        seed,
        backends=("jax", "pallas"),
        dtype=np.dtype(ml_dtypes.bfloat16),
        rtol=0.02,
        atol=0.01,
    )


@pytest.mark.parametrize("unpack", ["0", "1"])
@pytest.mark.parametrize("seed", range(4))
def test_random_program_bf16_canonical_storage(seed, unpack, monkeypatch):
    """The f16-STORAGE canonical form (the product build path: 16-bit
    dtypes store, statements compute in f32), with every stencil class
    in the kernel (``unpack="1"``) and under the default class rule
    (``"0"``).  Parity is bitwise either way (every widen is exact and
    the rounding points coincide by construction)."""
    import ml_dtypes

    from gt4py_tpu.cartesian.backend import pallas_backend

    if unpack == "0":
        monkeypatch.setattr(pallas_backend, "KERNEL_CLASSES", frozenset({"serial"}))
    run_differential_case(
        seed,
        backends=("jax", "pallas"),
        dtype=np.dtype(ml_dtypes.bfloat16),
        canonical_f16=True,
    )


@pytest.mark.parametrize("seed", range(8))
def test_random_program_bf16_aligned(seed):
    """bf16 on the wide geometry (origin 16, I on the 16 grid).
    Interpret mode on the CPU; the card runs the same legs
    (tests/test_gpu.py)."""
    import ml_dtypes

    run_differential_case(
        seed,
        backends=("pallas",),
        dtype=np.dtype(ml_dtypes.bfloat16),
        aligned=True,
        rtol=0.02,
        atol=0.01,
    )


@pytest.mark.parametrize("seed", range(30))
def test_random_program_periodic_parity(seed):
    """Periodic execution on random programs: the halo fill before the
    jax and pallas executors vs the oracle's fill.  Random read extents
    also hit the halo-wider-than-domain rejection path."""
    run_differential_case(seed, backends=("jax", "pallas"), periodic=("I", "J"))


@pytest.mark.parametrize("seed", range(8))
def test_random_program_periodic_f32_aligned(seed):
    """Wide-geometry periodic leg (dJ=128 with origin 128)."""
    run_differential_case(
        seed,
        backends=("pallas",),
        dtype=np.float32,
        aligned=True,
        periodic=("I", "J"),
        rtol=3e-5,
        atol=3e-6,
    )


@pytest.mark.parametrize("seed", [225, 513])
def test_fuzz_regression_dead_temp_dynamic_k(seed):
    """Sweep-found crash: a dead-code read of an unwritten temporary at a
    dynamic K position (a zeros value in the kernel)."""
    run_differential_case(seed, backends=("pallas",))


def test_fuzz_regression_bf16_fusion_emitter_crash():
    """Sweep-found XLA:CPU COMPILER segfault (not a numerics bug): a bf16
    program mixing sequential-K loops with variable-/absolute-K gathers
    crashed LLVM inside XLA's MLIR fusion emitters.  config.py now exports
    ``--xla_cpu_use_fusion_emitters=false`` at import time
    (GT4PY_TPU_CPU_FUSION_EMITTER_WORKAROUND); this pins the crashing
    seed so a jax upgrade that drops the workaround gets caught."""
    import ml_dtypes

    run_differential_case(
        107,
        backends=("jax", "pallas"),
        dtype=np.dtype(ml_dtypes.bfloat16),
        rtol=0.02,
        atol=0.01,
    )

"""Environment-driven configuration.

Mirrors the reference's env-config surface (reference:
src/gt4py/cartesian/config.py:24-94 and src/gt4py/next/config.py:69-177)
collapsed into one module.
"""

from __future__ import annotations

import os
from typing import Optional


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v is not None else default


#: Extra debug output (IR dumps on error, verbose exceptions).
DEBUG: bool = _env_bool("GT4PY_TPU_DEBUG", False)

#: Default backend used by ``@stencil`` when none is given.
DEFAULT_BACKEND: str = os.environ.get("GT4PY_TPU_DEFAULT_BACKEND", "jax")

#: Cache root for build artifacts (lowered-IR cache, native builds): a
#: fixed directory inside the checkout, independent of the working
#: directory.
CACHE_ROOT: str = os.environ.get(
    "GT4PY_TPU_CACHE_ROOT",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".gt4py_tpu_cache"),
)

#: Literal precision defaults (reference: cartesian/definitions.py:30-43).
LITERAL_FLOAT_PRECISION: int = _env_int("GT4PY_TPU_LITERAL_FLOAT_PRECISION", 64)
LITERAL_INT_PRECISION: int = _env_int("GT4PY_TPU_LITERAL_INT_PRECISION", 64)

#: Metrics collection level (reference: next/instrumentation/metrics.py:41-52).
#: 0=disabled, 10=minimal, 20=performance, 30=info, 40=verbose, 50=all
COLLECT_METRICS_LEVEL: int = _env_int("GT4PY_TPU_COLLECT_METRICS_LEVEL", 0)

#: Dump collected metrics as JSON at interpreter exit (path or empty).
DUMP_METRICS_AT_EXIT: Optional[str] = os.environ.get("GT4PY_TPU_DUMP_METRICS_AT_EXIT")

#: Whether jitted stencil executables may donate input buffers (in-place
#: semantics on device, saves HBM).  Disable for debugging aliasing issues.
DONATE_BUFFERS: bool = _env_bool("GT4PY_TPU_DONATE_BUFFERS", True)

#: Enable float64 support in JAX.  The reference numerics (numpy backend)
#: are float64; parity requires x64.  This is applied lazily on first JAX use.
ENABLE_X64: bool = _env_bool("GT4PY_TPU_ENABLE_X64", True)

#: Enable jax's persistent compilation cache, so stencil executables
#: survive process restarts (the reference's .gt_cache analog,
#: src/gt4py/cartesian/caching.py).  Where ``JAX_COMPILATION_CACHE_DIR`` is
#: set, JAX uses it and nothing is set here; otherwise the cache lives
#: under CACHE_ROOT.
PERSISTENT_CACHE: bool = _env_bool("GT4PY_TPU_PERSISTENT_CACHE", True)

#: Work around an XLA:CPU compiler crash (SIGSEGV in the MLIR fusion
#: emitters) on certain bfloat16 fusions that mix sequential-K scans with
#: variable-/absolute-K gathers (found by the differential fuzzer, seed
#: 107 of the cart-bf16 leg).  The flag is CPU-specific and inert for the
#: GPU compiler; it must reach XLA before the CPU client is created, so it
#: is applied at import time below.
CPU_FUSION_EMITTER_WORKAROUND: bool = _env_bool(
    "GT4PY_TPU_CPU_FUSION_EMITTER_WORKAROUND", True
)

if (
    CPU_FUSION_EMITTER_WORKAROUND
    and "xla_cpu_use_fusion_emitters" not in os.environ.get("XLA_FLAGS", "")
):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_cpu_use_fusion_emitters=false"
    ).strip()

#: Fuse eligible multi-statement next-DSL programs into one Pallas
#: kernel (pallas_bridge.lower_program).  Off -> every statement
#: dispatches its own operator kernel (the pre-r4 behavior); useful for
#: debugging and for measuring the fusion win.
PROGRAM_FUSION: bool = _env_bool("GT4PY_TPU_PROGRAM_FUSION", True)

#: Surface kernel-path fallbacks as Python warnings.  Both compiled
#: paths (cartesian pallas backend, next pallas bridge) silently drop to
#: the 3-5x-slower staged-XLA executor when a construct is outside the
#: kernel subset; the FALLBACK_EVENTS logs record every event, but a
#: user who did not opt into reading them should still see the cliff.
#: ``once`` (default) warns one time per (name, reason); ``always``
#: warns on every event; ``never`` keeps the logs silent.
WARN_ON_FALLBACK: str = os.environ.get("GT4PY_TPU_WARN_ON_FALLBACK", "once")


class PerformanceFallbackWarning(UserWarning):
    """A stencil/operator fell back from the fused-kernel path to the
    staged-XLA path (same numerics, typically 2-5x slower)."""


_warned_fallbacks: set = set()


def warn_fallback(what: str, reason: str) -> None:
    """Emit a :class:`PerformanceFallbackWarning` per WARN_ON_FALLBACK."""
    mode = WARN_ON_FALLBACK
    if mode not in ("once", "always"):
        return
    if mode == "once":
        key = (what, reason)
        if key in _warned_fallbacks:
            return
        _warned_fallbacks.add(key)
    import warnings

    warnings.warn(
        f"{what} fell back to the staged-XLA path: {reason} "
        "(same numerics, slower; silence with GT4PY_TPU_WARN_ON_FALLBACK=never)",
        PerformanceFallbackWarning,
        stacklevel=3,
    )


_x64_applied = False


def ensure_jax_config() -> None:
    """Apply process-wide JAX configuration (idempotent, lazy)."""
    global _x64_applied
    if _x64_applied:
        return
    import jax

    if ENABLE_X64:
        jax.config.update("jax_enable_x64", True)
    if PERSISTENT_CACHE and not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        cache_dir = os.path.join(CACHE_ROOT, "xla_cache")
        try:
            os.makedirs(cache_dir, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", cache_dir)
            jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
        except (OSError, AttributeError):
            pass
    _x64_applied = True

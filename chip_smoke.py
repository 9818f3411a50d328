"""Smoke test of the stencil main path on one GPU (or four, see below).

    python chip_smoke.py               # one card: phases 1-4
    python chip_smoke.py --four-cards  # four cards: the mesh path only

Phases on one card:

1. Device: JAX's default device must be a GPU (raises otherwise, printing
   no result); the card's name and power limit are printed.
2. Kernels against the plain reference at 512^2 x 80: one call of each
   stencil class through ``backend="pallas"`` with every class sent to the
   column kernel (hdiff, vadv, FV, shallow water, semi-Lagrangian, the
   next-DSL hdiff bridge, the fused mixed scan program, next tridiag).
   f64 results must match the numpy oracle to rtol 1e-11 (FMA contraction
   and libdevice transcendentals; no matrix product is on the path, so
   TF32 never enters).  f32 results must match the f64 oracle to rtol
   1e-4 (f32 rounding accumulated along a K sweep), allowing a fraction
   of 1e-4 of the points to take the other side of a data-dependent
   branch (``testing.program_gen``'s ``max_flip_fraction``); f32 kernel
   results must match the XLA executor's on the card the same way.  No
   stencil may fall back to XLA.  hdiff's chain and FV read fields written
   earlier in the same stencil at horizontal offsets: the inter-block race
   interpret mode cannot see.
3. Full size: ``FullDycore(2048, 2048, 128, float32)`` for a few steps
   through ``pallas`` and through ``jax``; fields finite and in agreement;
   the step time of each backend and the device-memory peak are printed.
4. The card-only tests (``pytest -m gpu``), in this process.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

``--four-cards``: ``MiniDycore`` + ``FvAdvection`` at a global 2048^2 x 128
f32 over a 2x2 ``CartesianMesh``, in each exchange mode (GSPMD global view,
explicit ``ppermute`` in ``shard_map``, the overlapped variant, the bf16
wire format), each compared with the same step on one card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
NI, NJ, NK = 512, 512, 80  # phase 2
FULL = (2048, 2048, 128)  # phase 3 and the four-card global domain
H = 3
F64_RTOL = 1e-11
F32_RTOL = 1e-4
FLIP_FRACTION = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def compare(name, got, ref, rtol, flips=0.0):
    """Max relative error of ``got`` against ``ref`` (scaled by the
    field's magnitude); raises past ``rtol`` unless at most a ``flips``
    fraction of the points is off."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {ref.shape}")
    if not np.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = np.abs(got - ref) / scale
    bad = err > rtol
    frac = float(bad.mean())
    if bad.any() and frac > flips:
        raise AssertionError(
            f"{name}: max rel err {err.max():.3e} > {rtol:g} at "
            f"{int(bad.sum())} points ({frac:.2e} of the field)"
        )
    return float(err[~bad].max()) if (~bad).any() else 0.0, frac


# --------------------------------------------------------------------------- #
# Phase 2: cartesian stencils
# --------------------------------------------------------------------------- #


def _cartesian_cases():
    from gt4py_tpu.models.dycore import make_hdiff, make_vadv
    from gt4py_tpu.models.fv_advection import make_fv_step
    from gt4py_tpu.models.semi_lagrangian import make_sl_stencil
    from gt4py_tpu.models.shallow_water import make_sw_step

    return [
        ("hdiff", make_hdiff, {}, ()),
        ("vadv", make_vadv, {"dtr_stage": 3.0}, ()),
        ("fv", make_fv_step, {}, ("I", "J")),
        ("shallow_water", make_sw_step, {}, ("I", "J")),
        ("semi_lagrangian", lambda dt, be: make_sl_stencil(dt, be, max_shift=1),
         {"dtdx": 1.0, "dtdy": 1.0}, ("I", "J")),
    ]


def _run_cartesian(make, dtype, backend, inputs, scalars, periodic):
    st = make(dtype, backend)
    arrays = {k: v.astype(dtype) for k, v in inputs.items()}
    names = [p.name for p in st.analysis.stencil.api_params if p.is_field]
    args = [arrays[n] for n in names]
    sc = {k: dtype(v) for k, v in scalars.items()}
    out = st(*args, origin=(H, H, 0), domain=(NI, NJ, NK), periodic=periodic,
             **sc)
    res = {n: np.asarray(a) for n, a in zip(names, args)}
    if isinstance(out, dict):
        res.update({k: np.asarray(v) for k, v in out.items()})
    written = [n for n in names if st.analysis.field_info[n].access.value & 2]
    return {n: res[n] for n in written}


def phase_cartesian(report):
    rng = np.random.default_rng(0)
    for name, make, scalars, periodic in _cartesian_cases():
        st = make(np.float64, "numpy")
        names = [p.name for p in st.analysis.stencil.api_params if p.is_field]
        shape = (NI + 2 * H, NJ + 2 * H, NK)
        inputs = {n: 0.4 * (rng.random(shape) - 0.5) for n in names}
        t0 = time.perf_counter()
        ref = _run_cartesian(make, np.float64, "numpy", inputs, scalars, periodic)
        t_ref = time.perf_counter() - t0
        k64 = _run_cartesian(make, np.float64, "pallas", inputs, scalars, periodic)
        k32 = _run_cartesian(make, np.float32, "pallas", inputs, scalars, periodic)
        x32 = _run_cartesian(make, np.float32, "jax", inputs, scalars, periodic)
        for f in ref:
            e64, _ = compare(f"{name}.{f} f64 kernel/oracle", k64[f], ref[f], F64_RTOL)
            e32, fl = compare(f"{name}.{f} f32 kernel/oracle", k32[f], ref[f],
                              F32_RTOL, FLIP_FRACTION)
            ex, flx = compare(f"{name}.{f} f32 kernel/xla", k32[f], x32[f],
                              F32_RTOL, FLIP_FRACTION)
            report.append((name, f, e64, e32, fl, ex, flx))
            log(f"  {name}.{f}: f64 {e64:.2e} | f32 {e32:.2e} (flips {fl:.1e})"
                f" | f32 vs xla {ex:.2e} (flips {flx:.1e}) | oracle {t_ref:.1f} s")


# --------------------------------------------------------------------------- #
# Phase 2: next-DSL stencils through the bridge
# --------------------------------------------------------------------------- #


def phase_next(report):
    import jax.numpy as jnp

    import gt4py_tpu.next as gtx
    from gt4py_tpu.next import Dims, Field, backends, program, where
    from gt4py_tpu.next.common import Domain, UnitRange as U

    I = gtx.Dimension("I")
    J = gtx.Dimension("J")
    K = gtx.Dimension("K", kind=gtx.DimensionKind.VERTICAL)
    Ioff = gtx.FieldOffset("Ioff", source=I, target=(I,))
    Joff = gtx.FieldOffset("Joff", source=J, target=(J,))
    rng = np.random.default_rng(1)
    SI, SJ = NI + 2 * H, NJ + 2 * H
    full = Domain((I, J, K), (U(0, SI), U(0, SJ), U(0, NK)))
    interior = Domain((I, J, K), (U(H, H + NI), U(H, H + NJ), U(0, NK)))

    def mk(dtype):
        FT = Field[Dims[I, J, K], dtype]

        @gtx.field_operator
        def hdiff(inp: FT, coeff: FT) -> FT:
            lap = 4.0 * inp - (
                inp(Ioff[1]) + inp(Ioff[-1]) + inp(Joff[1]) + inp(Joff[-1])
            )
            flx = lap(Ioff[1]) - lap
            flx = where(flx * (inp(Ioff[1]) - inp) > 0.0, 0.0, flx)
            fly = lap(Joff[1]) - lap
            fly = where(fly * (inp(Joff[1]) - inp) > 0.0, 0.0, fly)
            return inp - coeff * (flx - flx(Ioff[-1]) + fly - fly(Joff[-1]))

        @gtx.field_operator
        def lap_op(inp: FT) -> FT:
            return 4.0 * inp - (
                inp(Ioff[1]) + inp(Ioff[-1]) + inp(Joff[1]) + inp(Joff[-1])
            )

        @gtx.scan_operator(axis=K, forward=True, init=0.0)
        def integ(carry: dtype, x: dtype) -> dtype:
            return carry * 0.9 + x

        @gtx.field_operator
        def upd(inp: FT, acc: FT) -> FT:
            return inp - 0.1 * acc

        @program
        def mixed(inp: FT, lap: FT, acc: FT, res: FT):
            lap_op(inp, out=lap)
            integ(lap, out=acc)
            upd(inp, acc, out=res)

        @gtx.scan_operator(axis=K, forward=True, init=(0.0, 0.0))
        def tri_fwd(carry: tuple[dtype, dtype], a: dtype, b: dtype, c: dtype,
                    d: dtype):
            denom = b - a * carry[0]
            return (c / denom, (d - a * carry[1]) / denom)

        @gtx.scan_operator(axis=K, forward=False, init=0.0)
        def tri_bwd(carry: dtype, cp: dtype, dp: dtype) -> dtype:
            return dp - cp * carry

        return hdiff, mixed, tri_fwd, tri_bwd

    inp = rng.random((SI, SJ, NK))
    coeff = 0.025 * rng.random((SI, SJ, NK))
    a, c, d = (rng.random((NI, NJ, NK)) for _ in range(3))
    b = rng.random((NI, NJ, NK)) + 4.0

    def run(dtype, be):
        hdiff, mixed, tri_fwd, tri_bwd = mk(
            gtx.float64 if dtype == np.float64 else gtx.float32
        )
        xp = np if be == backends.numpy_oracle else jnp
        arr = lambda x: xp.asarray(x.astype(dtype))
        out = {}
        res = gtx.Field(interior, xp.zeros((NI, NJ, NK), dtype))
        hdiff.with_backend(be)(gtx.Field(full, arr(inp)), gtx.Field(full, arr(coeff)),
                               out=res, domain=interior)
        out["next_hdiff"] = np.asarray(res.data)
        fields = [gtx.Field(interior, xp.zeros((NI, NJ, NK), dtype)) for _ in range(3)]
        mixed.with_backend(be)(gtx.Field(full, arr(inp)), *fields)
        out["next_mixed_program"] = np.asarray(fields[2].data)
        f = lambda x: gtx.as_field((I, J, K), arr(x))
        cp, dp = tri_fwd.with_backend(be)(f(a), f(b), f(c), f(d))
        out["next_tridiag"] = np.asarray(tri_bwd.with_backend(be)(cp, dp).data)
        return out

    ref = run(np.float64, backends.numpy_oracle)
    k64 = run(np.float64, "pallas")
    k32 = run(np.float32, "pallas")
    x32 = run(np.float32, backends.jax_jit)
    for name in ref:
        e64, _ = compare(f"{name} f64 kernel/oracle", k64[name], ref[name], F64_RTOL)
        e32, fl = compare(f"{name} f32 kernel/oracle", k32[name], ref[name],
                          F32_RTOL, FLIP_FRACTION)
        ex, flx = compare(f"{name} f32 kernel/xla", k32[name], x32[name],
                          F32_RTOL, FLIP_FRACTION)
        report.append((name, "out", e64, e32, fl, ex, flx))
        log(f"  {name}: f64 {e64:.2e} | f32 {e32:.2e} (flips {fl:.1e})"
            f" | f32 vs xla {ex:.2e} (flips {flx:.1e})")


# --------------------------------------------------------------------------- #
# Phase 3: full size
# --------------------------------------------------------------------------- #


def phase_full(dev, steps=3):
    import jax
    import jax.numpy as jnp

    from gt4py_tpu.models.full_dycore import FullDycore

    n = FULL
    keys = ("u", "q", "qsl")
    finals, times = {}, {}
    for backend in ("pallas", "jax"):
        model = FullDycore(*n, dtype=np.float32, backend=backend)
        state = {k: jnp.asarray(v) for k, v in model.init_state(seed=3).items()}
        step = jax.jit(model.step_fn(), donate_argnums=0)
        t0 = time.perf_counter()
        state = step(state)
        jax.block_until_ready(state)
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(steps - 1):
            state = step(state)
        jax.block_until_ready(state)
        times[backend] = (time.perf_counter() - t0) / (steps - 1)
        finals[backend] = {k: np.asarray(state[k]) for k in keys}
        del state
        log(f"  full dycore {n} f32 {backend}: {times[backend] * 1e3:.3f} ms/step"
            f" (first call incl. compile {t_compile:.1f} s)")
    for k in keys:
        for backend in finals:
            if not np.isfinite(finals[backend][k]).all():
                raise AssertionError(f"full dycore {backend}.{k}: non-finite")
        e, fl = compare(f"full dycore {k} pallas/jax", finals["pallas"][k],
                        finals["jax"][k], F32_RTOL, FLIP_FRACTION)
        log(f"  full dycore {k}: pallas vs jax {e:.2e} (flips {fl:.1e})")
    peak = dev.memory_stats().get("peak_bytes_in_use", 0)
    log(f"  device memory peak: {peak / 2**30:.2f} GiB")
    return times, peak


# --------------------------------------------------------------------------- #
# Four cards
# --------------------------------------------------------------------------- #


def four_cards(devs, steps=3):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gt4py_tpu.models import MiniDycore
    from gt4py_tpu.models.dycore import periodic_fill
    from gt4py_tpu.models.fv_advection import FvAdvection
    from gt4py_tpu.parallel import (
        CartesianMesh,
        gather,
        overlapped_shard_map_stencil,
        shard_map_stencil,
    )

    if len(devs) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found {len(devs)}")
    cmesh = CartesianMesh((2, 2), devices=devs[:4])
    px, py = cmesh.shape
    gni, gnj, nk = FULL
    ni_l, nj_l = gni // px, gnj // py
    h = MiniDycore.HALO
    rng = np.random.default_rng(0)
    fields = {
        name: (scale * rng.random((nk, gni, gnj))).astype(np.float32)
        for name, scale in [("u", 1.0), ("coeff", 0.025), ("wcon", 0.2),
                            ("utens", 0.01), ("utens_stage", 1.0)]
    }
    names = tuple(fields)
    sharding = NamedSharding(cmesh.mesh, P(None, "x", "y"))
    one = devs[0]

    def timed(fn, state):
        out = fn(state)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(steps):
            out = fn(state)
        jax.block_until_ready(out)
        return out, (time.perf_counter() - t0) / steps

    # reference: the same step on one card, periodic halos
    single = MiniDycore(gni, gnj, nk, dtype=np.float32, backend="jax")

    def embed(a):
        buf = np.zeros(single.field_shape(), np.float32)
        buf[:, h:h + gni, h:h + gnj] = a
        return buf

    step1 = single.step_fn(fill_halos=True)
    fill = lambda s: {k: periodic_fill(v, h, gni, gnj) for k, v in s.items()}
    ref_fn = jax.jit(lambda s: step1(fill(s))["u"][:, h:h + gni, h:h + gnj])
    st1 = {k: jax.device_put(embed(v), one) for k, v in fields.items()}
    u_ref, t_one = timed(ref_fn, st1)
    u_ref = np.asarray(u_ref)
    del st1
    log(f"  dycore one card: {t_one * 1e3:.3f} ms/step")

    # GSPMD global view: the single-card step on sharded global buffers
    gv = {k: jax.device_put(embed(v), NamedSharding(cmesh.mesh, P(None, "x", "y")))
          for k, v in fields.items()}
    u_gv, t_gv = timed(ref_fn, gv)
    del gv
    results = {"gspmd": (gather(u_gv), t_gv)}

    local = MiniDycore(ni_l, nj_l, nk, dtype=np.float32, backend="jax")
    lstep = local.step_fn(fill_halos=False)
    kw = dict(field_names=names, spatial_axes=(1, 2))
    modes = {
        "shard_map": shard_map_stencil(lambda **f: lstep(dict(f)), cmesh, (h, h), **kw),
        "overlapped": overlapped_shard_map_stencil(
            local.region_step_factory(), cmesh, (h, h), local_shape=(ni_l, nj_l), **kw),
        "bf16_wire": shard_map_stencil(
            lambda **f: lstep(dict(f)), cmesh, (h, h), halo_wire_dtype=jnp.bfloat16, **kw),
    }
    gstate = {k: jax.device_put(v, sharding) for k, v in fields.items()}
    for mode, fn in modes.items():
        jf = jax.jit(lambda s, _fn=fn: _fn(**s)["u"])
        out, t = timed(jf, gstate)
        results[mode] = (gather(out), t)
    lines = []
    for mode, (u, t) in results.items():
        # bf16 wire rounds the exchanged strips to bf16 (8 bits of mantissa)
        tol = 2e-2 if mode == "bf16_wire" else 1e-6
        e, fl = compare(f"dycore {mode} vs one card", u, u_ref, tol, FLIP_FRACTION)
        lines.append((mode, t, e))
        log(f"  dycore {mode}: {t * 1e3:.3f} ms/step, max rel err {e:.2e}"
            f" (tolerance {tol:g})")

    # FV advection: one card vs the shard_map step
    fh = FvAdvection.HALO
    q = rng.random((nk, gni, gnj)).astype(np.float32)
    cx = (0.4 * (rng.random((nk, gni, gnj)) - 0.5)).astype(np.float32)
    cy = (0.4 * (rng.random((nk, gni, gnj)) - 0.5)).astype(np.float32)
    fv1 = FvAdvection(gni, gnj, nk, dtype=np.float32, backend="jax")
    emb = lambda a: jax.device_put(jnp.pad(jnp.asarray(a), ((0, 0), (fh, fh), (fh, fh))), one)
    fv_ref, t_fv1 = timed(jax.jit(lambda s: fv1.step_fn()(*s)[:, fh:-fh, fh:-fh]),
                          (emb(q), emb(cx), emb(cy)))
    fv_ref = np.asarray(fv_ref)
    fvl = FvAdvection(ni_l, nj_l, nk, dtype=np.float32, backend="jax").local_step_fn()
    fv_sm = shard_map_stencil(
        lambda **f: {"q": fvl(f["q"], f["cx"], f["cy"])}, cmesh, (fh, fh),
        field_names=("q", "cx", "cy"), spatial_axes=(1, 2))
    g = {k: jax.device_put(v, sharding) for k, v in (("q", q), ("cx", cx), ("cy", cy))}
    out, t_fv4 = timed(jax.jit(lambda s: fv_sm(**s)["q"]), g)
    e, _ = compare("fv shard_map vs one card", gather(out), fv_ref, 1e-6)
    log(f"  fv one card: {t_fv1 * 1e3:.3f} ms/step; shard_map: {t_fv4 * 1e3:.3f}"
        f" ms/step, max rel err {e:.2e}")
    return lines


# --------------------------------------------------------------------------- #


def run_gpu_tests() -> int:
    import pytest

    os.environ["GT4PY_TPU_TEST_PLATFORM"] = "gpu"
    return pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider",
         os.path.join(REPO, "tests", "test_gpu.py")]
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh path")
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {devs[0].platform} devices only")
    log(f"card: {card_line()}")
    log(f"devices: {len(devs)} x {devs[0].device_kind}")

    sys.path.insert(0, REPO)
    from gt4py_tpu import config

    config.ensure_jax_config()
    from gt4py_tpu.cartesian.backend import pallas_backend
    from gt4py_tpu.next import pallas_bridge

    if args.four_cards:
        log("four cards: MiniDycore + FvAdvection, 2048^2 x 128 f32, 2x2 mesh")
        four_cards(devs)
    else:
        events = lambda: (pallas_backend.FALLBACK_EVENTS.total,
                          pallas_bridge.FALLBACK_EVENTS.total)
        log("phase 2: kernels vs the plain reference, 512^2 x 80")
        default_classes = pallas_backend.KERNEL_CLASSES
        pallas_backend.KERNEL_CLASSES = pallas_backend.ALL_CLASSES
        before = events()
        log(f"  FALLBACK_EVENTS.total before: {before}")
        report = []
        phase_cartesian(report)
        phase_next(report)
        after = events()
        log(f"  FALLBACK_EVENTS.total after: {after}")
        if after != before:
            raise AssertionError(
                "kernel fallbacks: "
                f"{pallas_backend.FALLBACK_EVENTS[-5:]}"
                f" {pallas_bridge.FALLBACK_EVENTS[-5:]}"
            )
        pallas_backend.KERNEL_CLASSES = default_classes
        log("phase 3: FullDycore 2048^2 x 128 f32, pallas vs jax")
        phase_full(devs[0])
        log("phase 4: card-only tests")
        rc = run_gpu_tests()
        if rc != 0:
            raise AssertionError(f"card-only tests failed (pytest exit {rc})")
    log(f"card: {card_line()}")
    print(json.dumps({
        "ok": True,
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": len(devs)},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

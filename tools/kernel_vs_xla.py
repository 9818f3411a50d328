"""Column kernel against XLA, per stencil class, on the GPU.

For each model stencil (hdiff, vadv + update, FVTP2D step, shallow water,
semi-Lagrangian, the fused dycore) at each size, the stencil is iterated
inside one jit at two iteration counts through ``backend="pallas"`` with
every class sent to the column kernel, and through ``backend="jax"``; the
per-step time is the slope.  A ``jax.profiler`` trace of one more call
counts the device kernel launches per step.  Prints one JSON line.

Usage: python tools/kernel_vs_xla.py [--sizes 512x512x80,2048x2048x128]
       [--trace-dir DIR]
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

H = 3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def cases():
    from gt4py_tpu.models.dycore import make_dycore_fused, make_hdiff, make_vadv_update
    from gt4py_tpu.models.fv_advection import make_fv_step
    from gt4py_tpu.models.semi_lagrangian import make_sl_stencil
    from gt4py_tpu.models.shallow_water import make_sw_step

    return [
        ("hdiff", make_hdiff, {}, ()),
        ("vadv_update", make_vadv_update, {"dtr_stage": 3.0}, ()),
        ("dycore_fused", make_dycore_fused, {"dtr_stage": 3.0}, ()),
        ("fv_step", make_fv_step, {}, ("I", "J")),
        ("shallow_water", make_sw_step, {}, ("I", "J")),
        ("semi_lagrangian", lambda d, b: make_sl_stencil(d, b, max_shift=1),
         {"dtdx": 1.0, "dtdy": 1.0}, ("I", "J")),
    ]


def build(make, backend, n, scalars, periodic):
    """(step, state): one application of the stencil on physical
    (K, I, J) buffers, feeding every written field back."""
    import jax.numpy as jnp

    st = make(np.float32, backend)
    fn = st.functional(origin=(H, H, 0), domain=n, physical_layout=True,
                       periodic=periodic)
    names = [p.name for p in st.analysis.stencil.api_params if p.is_field]
    rng = np.random.default_rng(0)
    shape = (n[2], n[0] + 2 * H, n[1] + 2 * H)
    state = {k: jnp.asarray((0.4 * (rng.random(shape) - 0.5)).astype(np.float32))
             for k in names}
    sc = {k: np.float32(v) for k, v in scalars.items()}

    def step(s):
        out = fn(**s, **sc)
        return {**s, **out}

    return step, state


def slope(step, state, i1, i2):
    import jax

    def timed(iters):
        @jax.jit
        def run(s):
            final = jax.lax.fori_loop(0, iters, lambda _, x: step(x), s)
            return sum(jax.numpy.sum(v) for v in final.values())

        float(run(state))
        t0 = time.perf_counter()
        float(run(state))
        return time.perf_counter() - t0

    return (timed(i2) - timed(i1)) / (i2 - i1)


def launches(step, state, trace_dir, tag):
    """Device events of one jitted step, from a profiler trace: per GPU
    trace line, (event count, summed duration in ms)."""
    import jax

    fn = jax.jit(step)
    jax.block_until_ready(fn(state))
    d = os.path.join(trace_dir, tag)
    with jax.profiler.trace(d):
        jax.block_until_ready(fn(state))
    path = sorted(glob.glob(os.path.join(d, "**", "*.xplane.pb"), recursive=True))[-1]
    out = {}
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if "GPU" not in plane.name:
            continue
        for line in plane.lines:
            evs = list(line.events)
            out[f"{plane.name}|{line.name}"] = (
                len(evs), sum(e.duration_ns for e in evs) / 1e6
            )
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="512x512x80,2048x2048x128")
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()

    import jax

    from gt4py_tpu import config

    config.ensure_jax_config()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("needs a GPU")
    print(f"# card: {card_line()}", file=sys.stderr, flush=True)
    from gt4py_tpu.cartesian.backend import pallas_backend

    pallas_backend.KERNEL_CLASSES = pallas_backend.ALL_CLASSES
    rows = []
    for size in args.sizes.split(","):
        n = tuple(int(x) for x in size.split("x"))
        for name, make, scalars, periodic in cases():
            row = {"stencil": name, "size": size}
            for backend in ("pallas", "jax"):
                step, state = build(make, backend, n, scalars, periodic)
                # enough steps that the slope dwarfs the host clock's noise
                i1, i2 = (5, 25) if n[0] * n[1] * n[2] < 1e8 else (2, 6)
                row[f"{backend}_ms"] = slope(step, state, i1, i2) * 1e3
                if args.trace_dir:
                    row[f"{backend}_trace"] = launches(
                        step, state, args.trace_dir, f"{name}_{size}_{backend}"
                    )
                del state
            row["kernel_over_xla"] = row["pallas_ms"] / row["jax_ms"]
            rows.append(row)
            print(f"# {row}", file=sys.stderr, flush=True)
    print(json.dumps({"card": card_line(), "rows": rows}), flush=True)


if __name__ == "__main__":
    main()

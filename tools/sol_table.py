"""Analytic speed-of-light table for the bench kernels.

For every bench workload: flops/pt and bytes/pt from the IR
(analysis.estimate_flops_bytes), the model floor
``max(bytes / peak_bw, flops / peak_f32)`` per step at 512^2 x 80 f32, and,
given a ``bench.py`` JSON line, the attained share of that floor.  The
model is IR-side: the tool traces nothing on a device and pins the CPU.

Peaks come from ``PEAKS``, keyed by the ``device_kind`` JAX reports; the
device is read from the bench JSON or given with ``--device-kind``.  A
device not in the table is an error.

Usage: python tools/sol_table.py [--device-kind KIND] [bench.json]
"""

import argparse
import json
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

#: Published peaks by ``jax.devices()[0].device_kind``: device-memory
#: bandwidth (B/s) and float32 rate outside the tensor cores (FLOP/s).
#: Source: NVIDIA H100 Tensor Core GPU data sheet, SXM part (3.35 TB/s
#: HBM3, 67 TFLOP/s FP32); both assume the 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bw": 3.35e12, "f32": 67e12},
}


def peaks_for(device_kind: str) -> dict:
    """Peak table entry of ``device_kind``; raises for an unknown device."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


NI = NJ = 512
NK = 80


def stencil_rows():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from gt4py_tpu.models.dycore import make_hdiff, make_vadv, make_vadv_update
    from gt4py_tpu.models.fv_advection import make_fv_step
    from gt4py_tpu.models.shallow_water import ShallowWater

    f32 = np.float32
    rows = {}
    # the bench step runs TWO kernels: hdiff, then the fused
    # vadv+update stencil (models/dycore.py step_fn)
    rows["dycore (hdiff + vadv_update)"] = [
        make_hdiff(f32, "jax"),
        make_vadv_update(f32, "jax"),
    ]
    rows["FVTP2D step"] = [make_fv_step(f32, "jax")]
    sw = ShallowWater(64, 128, 4, dtype=f32, backend="jax")
    rows["shallow water step"] = [
        st for st in (getattr(sw, "stencil", None),) if st is not None
    ]
    if not rows["shallow water step"]:
        # model keeps its stencil(s) under another attribute; find them
        rows["shallow water step"] = [
            v
            for v in vars(sw).values()
            if hasattr(v, "builder") or type(v).__name__ == "StencilObject"
        ]
    rows["hdiff alone"] = [make_hdiff(f32, "jax")]
    return rows


def main():
    from gt4py_tpu.cartesian.analysis import estimate_flops_bytes

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bench_json", nargs="?", help="a bench.py output line")
    ap.add_argument("--device-kind", help="device kind when no JSON is given")
    args = ap.parse_args()
    measured, kind = {}, args.device_kind
    if args.bench_json:
        with open(args.bench_json) as f:
            res = json.loads(f.read().strip().splitlines()[-1])
        measured, kind = res.get("extra", {}), res["device"]["kind"]
    if kind is None:
        ap.error("give a bench JSON or --device-kind")
    peak = peaks_for(kind)

    points = NI * NJ * NK
    print(f"# {kind}: {peak['bw'] / 1e12:.2f} TB/s, {peak['f32'] / 1e12:.0f} TFLOP/s f32")
    print(f"{'workload':34s} {'flops/pt':>9s} {'bytes/pt':>9s} "
          f"{'flop floor':>11s} {'byte floor':>11s} {'model floor':>12s} bound")
    for name, stencils in stencil_rows().items():
        fl = by = 0.0
        for st in stencils:
            f, b = estimate_flops_bytes(st.analysis.stencil, NK)
            fl += f
            by += b
        t_flop = fl * points / peak["f32"] * 1e3
        t_byte = by * points / peak["bw"] * 1e3
        floor = max(t_flop, t_byte)
        bound = "compute" if t_flop > t_byte else "traffic"
        line = (f"{name:34s} {fl:9.1f} {by:9.1f} {t_flop:10.3f}ms "
                f"{t_byte:10.3f}ms {floor:11.3f}ms {bound}")
        key = ROW_KEYS.get(name)
        if key in measured:
            line += f"  attained {floor / measured[key]:.1%}"
        print(line)


#: bench.py ``extra`` key of each workload's measured step time (ms)
ROW_KEYS = {
    "dycore (hdiff + vadv_update)": "dycore_512_ms",
    "FVTP2D step": "fv_512_ms",
    "shallow water step": "shallow_water_512_ms",
}


if __name__ == "__main__":
    main()

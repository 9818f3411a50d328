"""A guided tour of the cartesian GTScript DSL (workshop-style).

Run me: ``JAX_PLATFORMS=cpu /opt/venv/bin/python examples/cartesian_tutorial.py``
(CI runs this file; every cell below executes).  The prose companion is
docs/cartesian_tutorial.md.  Reference analog: the workshop notebooks
under docs/user/next/workshop/ and the examples/ notebooks of GT4Py.

The mental model in one paragraph: you write a Python function over
3D fields; `@gtscript.stencil` parses it ONCE into a validated stencil
IR (race rules, dtype resolution, extent analysis) and hands it to a
backend -- `numpy` (the oracle that DEFINES the numerics), `debug`
(plain loops, easiest to read), `jax` (XLA), or `pallas` (Triton column
kernels with a visible XLA fallback).  All backends agree to
1e-12 on f64 by construction.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from gt4py_tpu import storage
from gt4py_tpu.cartesian import gtscript
from gt4py_tpu.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    computation,
    interval,
)

Field = gtscript.Field[np.float64]

# --------------------------------------------------------------------- #
# Cell 1: the smallest stencil.  `computation(PARALLEL)` means every
# statement is a whole-domain parallel assignment; `interval(...)` is
# the full vertical range.
# --------------------------------------------------------------------- #


@gtscript.stencil(backend="numpy")
def copy(src: Field, dst: Field):
    with computation(PARALLEL), interval(...):
        dst = src


a = storage.from_array(np.random.rand(8, 8, 4), backend="numpy")
b = storage.zeros((8, 8, 4), backend="numpy")
copy(a, b)
assert np.array_equal(np.asarray(a), np.asarray(b))
print("cell 1: copy stencil OK")

# --------------------------------------------------------------------- #
# Cell 2: offsets, halos, origins.  `u[1, 0, 0]` reads the I+1
# neighbor; fields therefore need a halo, and `origin` says where the
# compute domain starts inside each buffer.  The domain is inferred
# from shapes minus the stencil's computed boundary -- or passed
# explicitly.
# --------------------------------------------------------------------- #


@gtscript.stencil(backend="numpy")
def laplacian(u: Field, lap: Field):
    with computation(PARALLEL), interval(...):
        lap = -4.0 * u[0, 0, 0] + u[1, 0, 0] + u[-1, 0, 0] + u[0, 1, 0] + u[0, -1, 0]


n = 10
u = storage.from_array(
    np.fromfunction(lambda i, j, k: i * i + j, (n, n, 3)),
    backend="numpy",
    aligned_index=(1, 1, 0),  # halo width 1: the compute origin
)
lap = storage.zeros((n, n, 3), backend="numpy", aligned_index=(1, 1, 0))
laplacian(u, lap, origin=(1, 1, 0), domain=(n - 2, n - 2, 3))
# d2/di2 + d2/dj2 of i^2 + j is 2
assert np.allclose(np.asarray(lap)[1:-1, 1:-1, :], 2.0)
print("cell 2: laplacian with halo/origin OK")

# The parse result is inspectable: `str(stencil)` prints per-field
# access kinds and boundaries (the extent analysis), `lowered()` dumps
# the IR / jaxpr / HLO without executing.
info = str(laplacian)
assert "u" in info and "lap" in info
assert "computation(PARALLEL)" in laplacian.lowered(format="ir")
print("cell 3: extent analysis says boundary(u) =", laplacian.field_info["u"].boundary)

# --------------------------------------------------------------------- #
# Cell 4: temporaries + stage fusion.  Assigning to an undeclared name
# creates a TEMPORARY field; the extent analysis computes the halo each
# stage needs, and executors evaluate temporaries over the extended
# region automatically (in the column kernel, temporaries read only at
# their own point stay in registers).  This is the canonical horizontal-diffusion pattern.
# --------------------------------------------------------------------- #


@gtscript.stencil(backend="numpy")
def hdiff(inp: Field, out: Field, coeff: Field):
    with computation(PARALLEL), interval(...):
        lap_t = 4.0 * inp[0, 0, 0] - (
            inp[1, 0, 0] + inp[-1, 0, 0] + inp[0, 1, 0] + inp[0, -1, 0]
        )
        res1 = lap_t[1, 0, 0] - lap_t[0, 0, 0]
        flx = 0 if (res1 * (inp[1, 0, 0] - inp[0, 0, 0])) > 0 else res1
        res2 = lap_t[0, 1, 0] - lap_t[0, 0, 0]
        fly = 0 if (res2 * (inp[0, 1, 0] - inp[0, 0, 0])) > 0 else res2
        out = inp[0, 0, 0] - coeff[0, 0, 0] * (
            flx[0, 0, 0] - flx[-1, 0, 0] + fly[0, 0, 0] - fly[0, -1, 0]
        )


h = 2  # lap at +-1 read at +-1 again -> halo 2
shape = (16 + 2 * h, 16 + 2 * h, 4)
rng = np.random.default_rng(0)
inp = storage.from_array(rng.random(shape), backend="numpy", aligned_index=(h, h, 0))
outp = storage.zeros(shape, backend="numpy", aligned_index=(h, h, 0))
cf = storage.from_array(0.05 * rng.random(shape), backend="numpy", aligned_index=(h, h, 0))
hdiff(inp, outp, cf, origin=(h, h, 0), domain=(16, 16, 4))
print("cell 4: hdiff with temporaries OK")

# --------------------------------------------------------------------- #
# Cell 5: sequential K -- scans and tridiagonal solves.  FORWARD /
# BACKWARD computations execute level by level; reading the written
# field at [0, 0, -1] is the carry.  This is the Thomas algorithm, the
# vertical core of every atmosphere model.
# --------------------------------------------------------------------- #


@gtscript.stencil(backend="numpy")
def tridiag(a: Field, b: Field, c: Field, d: Field, x: Field):
    with computation(FORWARD):
        with interval(0, 1):
            cp = c / b
            dp = d / b
        with interval(1, None):
            cp = c / (b - cp[0, 0, -1] * a)
            dp = (d - dp[0, 0, -1] * a) / (b - cp[0, 0, -1] * a)
    with computation(BACKWARD):
        with interval(-1, None):
            x = dp
        with interval(0, -1):
            x = dp - cp * x[0, 0, 1]


nk = 30
sh = (4, 4, nk)
mk = lambda arr: storage.from_array(arr, backend="numpy")
A = mk(np.full(sh, -1.0))
B = mk(np.full(sh, 2.6))
C = mk(np.full(sh, -1.0))
D = mk(rng.random(sh))
X = storage.zeros(sh, backend="numpy")
tridiag(A, B, C, D, X, origin=(0, 0, 0), domain=sh)
# verify |Ax - d| ~ 0 column by column
x = np.asarray(X)
res = np.asarray(B) * x
res[:, :, 1:] += np.asarray(A)[:, :, 1:] * x[:, :, :-1]
res[:, :, :-1] += np.asarray(C)[:, :, :-1] * x[:, :, 1:]
assert np.abs(res - np.asarray(D)).max() < 1e-12
print("cell 5: tridiagonal solve residual < 1e-12")

# --------------------------------------------------------------------- #
# Cell 6: the backend matrix.  The SAME definition runs on every
# backend; numpy is the oracle, jax/pallas are the product path.
# (On a GPU, backend="pallas" compiles Triton column kernels; on the
# CPU it runs the same kernels in interpret mode.)
# --------------------------------------------------------------------- #

def lap_defn(u: Field, lap: Field):
    with computation(PARALLEL), interval(...):
        lap = -4.0 * u[0, 0, 0] + u[1, 0, 0] + u[-1, 0, 0] + u[0, 1, 0] + u[0, -1, 0]


results = {}
for backend in ("numpy", "debug", "jax", "pallas"):
    st = gtscript.stencil(backend=backend, name=f"tut_lap_{backend}")(lap_defn)
    uu = storage.from_array(
        np.asarray(u), backend=backend, aligned_index=(1, 1, 0)
    )
    ll = storage.zeros((n, n, 3), backend=backend, aligned_index=(1, 1, 0))
    st(uu, ll, origin=(1, 1, 0), domain=(n - 2, n - 2, 3))
    results[backend] = np.asarray(ll)
for backend, got in results.items():
    np.testing.assert_allclose(got, results["numpy"], rtol=1e-12, err_msg=backend)
print("cell 6: all four backends agree to 1e-12")

# --------------------------------------------------------------------- #
# Cell 7: instrumentation.  Per-call timings via exec_info; build-phase
# timings via build_info at stencil() time; the pallas backend records
# its chosen tile plan in LAST_PLAN and every XLA fallback in
# FALLBACK_EVENTS (a silent 3-5x cliff would otherwise be invisible).
# --------------------------------------------------------------------- #

exec_info = {}
copy(a, b, exec_info=exec_info)
assert exec_info["call_run_end_time"] >= exec_info["call_run_start_time"]
from gt4py_tpu.cartesian.backend import pallas_backend

print("cell 7: exec_info keys:", sorted(k for k in exec_info if k.endswith("time")))
print("        fallback events so far:", len(pallas_backend.FALLBACK_EVENTS))

print("tutorial complete")

"""The pallas column kernel on the CPU (interpret mode).

Every test runs the same kernel the GPU compiles (the Triton lowering is
checked for CUDA on every call) and compares it with the numpy oracle:
math functions, ragged domains, serial-K carries, periodic axes, scalar
operands, buffer aliasing, the gradient rule and the class rule.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest

from gt4py_tpu.cartesian import gtscript, ir
from gt4py_tpu.cartesian.analysis import analyze
from gt4py_tpu.cartesian.backend import from_name, pallas_backend
from gt4py_tpu.cartesian.gtscript import (
    BACKWARD,
    FORWARD,
    PARALLEL,
    computation,
    interval,
)

F = gtscript.Field[np.float64]
F32 = gtscript.Field[np.float32]
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pytestmark = pytest.mark.usefixtures("all_kernel_classes")


def _run(stencil, arrays, domain, origin, scalars=None, periodic=()):
    """(oracle, kernel) results of raw IR on copies of ``arrays``."""
    an = analyze(stencil)
    ref = {k: v.copy() for k, v in arrays.items()}
    origins = {k: origin for k in arrays}
    from_name("numpy")(an).run(ref, dict(scalars or {}), domain, origins,
                               periodic=periodic)
    got = {k: v.copy() for k, v in arrays.items()}
    out = pallas_backend.PallasBackend(an, {}).run(
        got, dict(scalars or {}), domain, origins, periodic=periodic
    )
    got.update({k: np.asarray(v) for k, v in out.items()})
    return ref, got


def _kernel_ran(name, before):
    assert name in pallas_backend.LAST_PLAN
    events = [e for e in pallas_backend.FALLBACK_EVENTS.since(before)]
    assert not events, events


# --------------------------------------------------------------------------- #
# math functions
# --------------------------------------------------------------------------- #


def _unary_template():
    @gtscript.stencil(backend="numpy", name="native_tmpl")
    def tmpl(a: F, b: F, out: F):
        with computation(PARALLEL), interval(...):
            out = a + b

    return tmpl.analysis.stencil


_TWO_ARGS = {"MIN", "MAX", "MOD", "ARCTAN2", "POW"}
#: primitives the installed Pallas Triton lowering does not implement:
#: these stencils take the visible XLA fallback
_NO_TRITON = {"ROUND", "GAMMA", "ERF", "ERFC"}


@pytest.mark.parametrize("fname", sorted(ir.NativeFunction.__members__))
def test_native_function_in_kernel(fname):
    """Each math function lowers for CUDA and matches the oracle, or (the
    few the Triton lowering lacks) falls back visibly with the reason."""
    func = ir.NativeFunction[fname]
    st = copy.deepcopy(_unary_template())
    st.name = f"native_{fname.lower()}"
    a = ir.FieldAccess(name="a", offset=ir.CartesianOffset())
    b = ir.FieldAccess(name="b", offset=ir.CartesianOffset())
    if func == ir.NativeFunction.ARCCOSH:
        a = ir.BinaryOp(ir.BinaryOperator.ADD, a, ir.Literal(1.5, np.dtype(np.float64)))
    args = [a, b] if fname in _TWO_ARGS else [a]
    call = ir.NativeFuncCall(func, args)
    if func in (ir.NativeFunction.ISFINITE, ir.NativeFunction.ISINF,
                ir.NativeFunction.ISNAN):
        call = ir.TernaryOp(call, ir.Literal(1.0, np.dtype(np.float64)),
                            ir.Literal(0.0, np.dtype(np.float64)))
    st.vertical_loops[0].sections[0].body[0].value = call
    rng = np.random.default_rng(1)
    shape = (9, 10, 3)
    arrays = {"a": 0.1 + 0.8 * rng.random(shape), "b": 0.1 + 0.8 * rng.random(shape),
              "out": np.zeros(shape)}
    before = pallas_backend.FALLBACK_EVENTS.cursor()
    ref, got = _run(st, arrays, (9, 10, 3), (0, 0, 0))
    if fname in _NO_TRITON:
        (name, reason), = pallas_backend.FALLBACK_EVENTS.since(before)
        assert name == st.name and "Unimplemented primitive" in reason
    else:
        _kernel_ran(st.name, before)
    np.testing.assert_allclose(got["out"], ref["out"], rtol=1e-13, atol=1e-15)


# --------------------------------------------------------------------------- #
# ragged domains, both classes
# --------------------------------------------------------------------------- #


def _lap(a: F, out: F):
    with computation(PARALLEL), interval(...):
        out = a[1, 0, 0] + a[-1, 0, 0] + a[0, 1, 0] + a[0, -1, 0] - 4.0 * a


def _csum(a: F, out: F):
    with computation(FORWARD):
        with interval(0, 1):
            out = a[1, 0, 0]
        with interval(1, None):
            out = out[0, 0, -1] + a[0, -1, 0]


@pytest.mark.parametrize("kind", ["parallel", "serial"])
@pytest.mark.parametrize("n", [1, 7, 33, 130])
def test_ragged_domains(n, kind):
    """Domains 1, 7, 33 and 130 wide: blocks overhang the domain and the
    buffer on both axes; the masks keep every point exact."""
    defn = _lap if kind == "parallel" else _csum
    st = gtscript.stencil(backend="numpy", name=f"ragged_{kind}_{n}")(defn)
    dom = (n, max(1, 135 - n), 3)
    shape = (dom[0] + 2, dom[1] + 2, 3)
    rng = np.random.default_rng(n)
    arrays = {"a": rng.random(shape), "out": np.zeros(shape)}
    before = pallas_backend.FALLBACK_EVENTS.cursor()
    ref, got = _run(st.analysis.stencil, arrays, dom, (1, 1, 0))
    _kernel_ran(st.analysis.stencil.name, before)
    np.testing.assert_array_equal(got["out"], ref["out"])


# --------------------------------------------------------------------------- #
# serial-K carries
# --------------------------------------------------------------------------- #


def _fwd1(a: F, out: F):
    with computation(FORWARD), interval(...):
        out = 0.5 * out[0, 0, -1] + a


def _fwd2(a: F, out: F):
    with computation(FORWARD), interval(...):
        out = 0.5 * out[0, 0, -2] + a


def _fwd3(a: F, out: F):
    with computation(FORWARD), interval(...):
        out = 0.5 * out[0, 0, -3] + 0.25 * out[0, 0, -1] + a


def _bwd1(a: F, out: F):
    with computation(BACKWARD), interval(...):
        out = 0.5 * out[0, 0, 1] + a


def _bwd2(a: F, out: F):
    with computation(BACKWARD), interval(...):
        out = 0.5 * out[0, 0, 2] + a


def _bwd3(a: F, out: F):
    with computation(BACKWARD), interval(...):
        out = 0.5 * out[0, 0, 3] + 0.25 * out[0, 0, 1] + a


_CARRY = {("FORWARD", 1): _fwd1, ("FORWARD", 2): _fwd2, ("FORWARD", 3): _fwd3,
          ("BACKWARD", 1): _bwd1, ("BACKWARD", 2): _bwd2, ("BACKWARD", 3): _bwd3}


def _carry_stencil(order, depth):
    return gtscript.stencil(backend="numpy", name=f"carry_{order}_{depth}")(
        _CARRY[order, depth])


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("order", ["FORWARD", "BACKWARD"])
def test_serial_carries(order, depth):
    """Reads behind the sweep at depth 1-3 come from the K-cache; the
    carried planes at the sweep start come from memory."""
    st = _carry_stencil(order, depth).analysis.stencil
    shape = (6, 7, 12)
    rng = np.random.default_rng(depth)
    arrays = {"a": rng.random(shape), "out": rng.random(shape)}
    before = pallas_backend.FALLBACK_EVENTS.cursor()
    ref, got = _run(st, arrays, (4, 5, 6), (1, 1, 3))
    _kernel_ran(st.name, before)
    assert pallas_backend.LAST_PLAN[st.name]["carries"] == ["out"]
    np.testing.assert_allclose(got["out"], ref["out"], rtol=1e-14)


# --------------------------------------------------------------------------- #
# periodic axes
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("axes", [("I",), ("J",), ("I", "J")])
def test_periodic_axes(axes, small, monkeypatch):
    if small:
        monkeypatch.setattr(
            pallas_backend, "plan_blocks",
            lambda ni, nj, itemsize=4: pallas_backend.BlockPlan(2, 4, 1, 2),
        )
    st = gtscript.stencil(backend="numpy", name=f"per_{''.join(axes)}_{small}")(_lap)
    shape = (14, 17, 3)
    rng = np.random.default_rng(3)
    arrays = {"a": rng.random(shape), "out": np.zeros(shape)}
    before = pallas_backend.FALLBACK_EVENTS.cursor()
    ref, got = _run(st.analysis.stencil, arrays, (12, 15, 3), (1, 1, 0),
                    periodic=axes)
    _kernel_ran(st.analysis.stencil.name, before)
    np.testing.assert_array_equal(got["out"], ref["out"])


# --------------------------------------------------------------------------- #
# scalars, aliasing, gradients
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["parallel", "serial"])
def test_traced_scalar_operands(kind):
    """A scalar traced under jit is a kernel operand, not a constant."""
    import jax
    import jax.numpy as jnp

    def par(a: F32, out: F32, *, w: np.float32):
        with computation(PARALLEL), interval(...):
            out = a[1, 0, 0] * w + a

    def ser(a: F32, out: F32, *, w: np.float32):
        with computation(FORWARD):
            with interval(0, 1):
                out = a * w
            with interval(1, None):
                out = out[0, 0, -1] * w + a

    defn = par if kind == "parallel" else ser
    fns = {
        be: gtscript.stencil(backend=be, name=f"scal_{kind}_{be}")(defn).functional(
            origin=(1, 1, 0), domain=(6, 8, 4)
        )
        for be in ("jax", "pallas")
    }
    x = jnp.asarray(np.random.default_rng(2).random((8, 10, 4), dtype=np.float32))
    outs = {
        be: jax.jit(lambda a, w, _f=f: _f(a=a, out=jnp.zeros_like(a), w=w)["out"])(
            x, jnp.float32(0.3)
        )
        for be, f in fns.items()
    }
    assert f"scal_{kind}_pallas" in pallas_backend.LAST_PLAN
    np.testing.assert_allclose(np.asarray(outs["pallas"]), np.asarray(outs["jax"]),
                               rtol=1e-6)


@pytest.mark.parametrize("read_written", [False, True])
def test_input_output_aliases(read_written):
    """Written buffers alias their inputs: halos and points outside the
    write extent keep their values, whether or not the field is read."""

    def write_only(a: F, out: F):
        with computation(PARALLEL), interval(...):
            out = a[1, 0, 0]

    def read_write(a: F, out: F):
        with computation(PARALLEL), interval(...):
            out = out + a[1, 0, 0]

    defn = read_write if read_written else write_only
    st = gtscript.stencil(backend="numpy", name=f"alias_{read_written}")(defn)
    shape = (9, 9, 2)
    rng = np.random.default_rng(4)
    arrays = {"a": rng.random(shape), "out": rng.random(shape)}
    ref, got = _run(st.analysis.stencil, arrays, (5, 5, 2), (2, 2, 0))
    np.testing.assert_array_equal(got["out"], ref["out"])
    np.testing.assert_array_equal(got["out"][:2], arrays["out"][:2])


@pytest.mark.parametrize("kind", ["parallel", "serial"])
@pytest.mark.parametrize("argnum", [0, 1])
def test_gradient_rule(argnum, kind):
    """jax.grad through the kernel: the primal runs the kernel, the
    tangents run the XLA executor (PallasBackend._trace_env)."""
    import jax
    import jax.numpy as jnp

    def par(a: F, out: F, *, w: float):
        with computation(PARALLEL), interval(...):
            out = a - w * (a[1, 0, 0] + a[-1, 0, 0] - 2.0 * a)

    def ser(a: F, out: F, *, w: float):
        with computation(FORWARD):
            with interval(0, 1):
                out = a
            with interval(1, None):
                out = w * out[0, 0, -1] + a[1, 0, 0]

    defn = par if kind == "parallel" else ser
    fns = {
        be: gtscript.stencil(backend=be, name=f"grad_{kind}_{be}")(defn).functional(
            origin=(1, 0, 0), domain=(6, 5, 4)
        )
        for be in ("jax", "pallas")
    }
    x = jnp.asarray(np.random.default_rng(5).random((8, 5, 4)))

    def loss(fn, a, w):
        return jnp.sum(fn(a=a, out=jnp.zeros_like(a), w=w)["out"] ** 2)

    g = {be: jax.grad(lambda a, w, _f=f: loss(_f, a, w), argnum)(x, 0.2)
         for be, f in fns.items()}
    np.testing.assert_allclose(np.asarray(g["pallas"]), np.asarray(g["jax"]),
                               rtol=1e-12)
    assert np.abs(np.asarray(g["jax"])).max() > 0


# --------------------------------------------------------------------------- #
# the class rule and the fallback
# --------------------------------------------------------------------------- #


def test_kernel_class_parallel():
    st = gtscript.stencil(backend="numpy", name="cls_par")(_lap)
    assert pallas_backend.kernel_class(st.analysis.stencil) == "parallel"


def test_kernel_class_serial():
    st = gtscript.stencil(backend="numpy", name="cls_ser")(_csum)
    assert pallas_backend.kernel_class(st.analysis.stencil) == "serial"


@pytest.mark.parametrize("option", [None, "all"])
def test_class_rule_routes_visibly(option, monkeypatch):
    """Under the default rule an all-PARALLEL stencil runs on XLA through
    the visible fallback; with every class admitted it runs the kernel."""
    classes = pallas_backend.ALL_CLASSES if option else frozenset({"serial"})
    monkeypatch.setattr(pallas_backend, "KERNEL_CLASSES", classes)
    name = f"cls_rule_{option}"
    st = gtscript.stencil(backend="pallas", name=name)(_lap)
    a = np.random.default_rng(6).random((8, 8, 2))
    out = np.zeros_like(a)
    before = pallas_backend.FALLBACK_EVENTS.cursor()
    st(a, out, origin=(1, 1, 0), domain=(6, 6, 2))
    events = pallas_backend.FALLBACK_EVENTS.since(before)
    if option:
        assert not events and name in pallas_backend.LAST_PLAN
    else:
        assert events and "class rule" in events[0][1], events
    ref = np.zeros_like(a)
    gtscript.stencil(backend="numpy", name=name + "_np")(_lap)(
        a, ref, origin=(1, 1, 0), domain=(6, 6, 2))
    np.testing.assert_array_equal(out, ref)


def test_lowering_refusal_falls_back(monkeypatch):
    """A kernel the Triton lowering refuses becomes a recorded fallback
    with the same numbers, never an error in the caller's program."""

    def refuse(call, operands):
        raise pallas_backend._PallasIneligible("Triton lowering: refused")

    monkeypatch.setattr(pallas_backend, "_check_lowering", refuse)
    st = gtscript.stencil(backend="pallas", name="refused")(_csum)
    a = np.random.default_rng(7).random((8, 8, 3))
    out = np.zeros_like(a)
    before = pallas_backend.FALLBACK_EVENTS.cursor()
    st(a, out, origin=(1, 1, 0), domain=(6, 6, 3))
    events = pallas_backend.FALLBACK_EVENTS.since(before)
    assert events and "Triton lowering" in events[0][1]
    ref = np.zeros_like(a)
    gtscript.stencil(backend="numpy", name="refused_np")(_csum)(
        a, ref, origin=(1, 1, 0), domain=(6, 6, 3))
    np.testing.assert_array_equal(out, ref)


# --------------------------------------------------------------------------- #
# tools and entry points
# --------------------------------------------------------------------------- #


def test_sol_table_known_device():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import sol_table

    peak = sol_table.peaks_for("NVIDIA H100 80GB HBM3")
    assert peak == {"bw": 3.35e12, "f32": 67e12}


def test_sol_table_unknown_device_raises():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import sol_table

    with pytest.raises(KeyError, match="no published peaks"):
        sol_table.peaks_for("some accelerator")


def _python(args, env_extra=None, cwd=None):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **(env_extra or {})}
    return subprocess.run(
        [sys.executable, *args], capture_output=True, text=True, timeout=300,
        env=env, cwd=cwd or REPO,
    )


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_entry_points_refuse_without_gpu(script):
    """Without a GPU both scripts raise and print no result."""
    res = _python([os.path.join(REPO, script)])
    assert res.returncode != 0
    assert "needs a GPU" in res.stderr
    assert "{" not in res.stdout


def test_compile_cache_follows_env(tmp_path):
    code = (
        "import jax; from gt4py_tpu import config; config.ensure_jax_config();"
        "print(jax.config.jax_compilation_cache_dir)"
    )
    res = _python(["-c", code], {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == str(tmp_path)


def test_compile_cache_fixed_in_checkout(tmp_path):
    """Without the variable the cache sits inside the checkout, wherever
    the process starts."""
    code = (
        f"import sys; sys.path.insert(0, {REPO!r});"
        "import jax; from gt4py_tpu import config; config.ensure_jax_config();"
        "print(jax.config.jax_compilation_cache_dir)"
    )
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("GT4PY_TPU_CACHE_ROOT", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    want = os.path.join(REPO, ".gt4py_tpu_cache", "xla_cache")
    assert res.stdout.strip().splitlines()[-1] == want

"""JAX/XLA executor.

The stencil IR is *traced* into an XLA program under ``jax.jit`` -- tracing
makes interpretation free at runtime and lets XLA fuse whole PARALLEL
sections into single kernels.  Sequential FORWARD/BACKWARD loops lower to
``lax.scan`` over K planes (``lax.fori_loop`` with dynamic plane slices
where the scan form does not apply).

Semantics parity: identical statement ordering, explicit C-style dtype
promotion and the same clipping rules as the numpy oracle backend, so
float64 results are bit-comparable to the reference numerics.

Reference behavior being reproduced: the numpy backend's computation
semantics (src/gt4py/cartesian/gtc/numpy/npir_codegen.py) -- re-designed
as a traced functional program instead of generated source.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from gt4py_tpu import config
from gt4py_tpu.cartesian import ir
from gt4py_tpu.cartesian.analysis import (
    StencilAnalysis,
    default_float_dtype,
    default_int_dtype,
    is_float_dtype,
    promote_dtypes,
)
from gt4py_tpu.cartesian.backend import register
from gt4py_tpu.core.definitions import Extent

def _jax():
    config.ensure_jax_config()
    import jax

    return jax


@dataclass(frozen=True)
class _FieldMeta:
    """Static per-call metadata of one field buffer."""

    shape: Tuple[int, ...]  # full 3D+data shape (missing axes size 1)
    origin: Tuple[int, int, int]
    dtype: np.dtype
    dimensions: Tuple[bool, bool, bool]
    data_ndim: int


class _TraceCtx:
    """Context while tracing one statement unit."""

    def __init__(self, exe, ext: Extent, kslice=None, klevel=None):
        self.exe = exe
        self.ext = ext
        self.kslice = kslice  # (k0, k1) python ints, parallel sections
        self.klevel = klevel  # traced or python int, serial sections
        self.masks: List[Any] = []

    @property
    def ni(self):
        return self.exe.domain[0] - self.ext.i[0] + self.ext.i[1]

    @property
    def nj(self):
        return self.exe.domain[1] - self.ext.j[0] + self.ext.j[1]

    @property
    def nk(self):
        return 1 if self.klevel is not None else self.kslice[1] - self.kslice[0]

    def shape(self):
        """Physical evaluation shape: buffers are K-leading (K, I, J)."""
        return (self.nk, self.ni, self.nj)


def _phys_shape(logical_shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Logical (I, J, K, *dd) -> physical (K, I, J, *dd).

    The executor stores every buffer K-leading: serial-K scans slice
    contiguous planes off axis 0 with no transposes, and J, the long
    horizontal axis, is the contiguous one (coalesced accesses on the GPU).
    This is the reference's 'K-first' layout choice
    (storage/cartesian/layout_registry.py).
    """
    return (logical_shape[2], logical_shape[0], logical_shape[1]) + tuple(
        logical_shape[3:]
    )


_NATIVE_JNP: Dict[ir.NativeFunction, Callable] = {}


def _init_native_jnp():
    import jax
    import jax.numpy as jnp
    import jax.scipy.special as jsp

    def round_away_from_zero(x):
        half = jnp.asarray(
            0.5, dtype=x.dtype if is_float_dtype(x.dtype) else jnp.float64
        )
        return jnp.trunc(x + jnp.copysign(half, x))

    def gamma(x):
        # Gamma via gammaln for x>0; reflection formula
        # pi / (sin(pi x) * gamma(1-x)) for x<=0.
        pos = jnp.exp(jsp.gammaln(x))
        neg = jnp.pi / (jnp.sin(jnp.pi * x) * jnp.exp(jsp.gammaln(1.0 - x)))
        return jnp.where(x > 0, pos, neg)

    _NATIVE_JNP.update(
        {
            ir.NativeFunction.ABS: jnp.abs,
            ir.NativeFunction.MIN: jnp.minimum,
            ir.NativeFunction.MAX: jnp.maximum,
            ir.NativeFunction.MOD: jnp.mod,
            ir.NativeFunction.SIN: jnp.sin,
            ir.NativeFunction.COS: jnp.cos,
            ir.NativeFunction.TAN: jnp.tan,
            ir.NativeFunction.ARCSIN: jnp.arcsin,
            ir.NativeFunction.ARCCOS: jnp.arccos,
            ir.NativeFunction.ARCTAN: jnp.arctan,
            ir.NativeFunction.ARCTAN2: jnp.arctan2,
            ir.NativeFunction.SINH: jnp.sinh,
            ir.NativeFunction.COSH: jnp.cosh,
            ir.NativeFunction.TANH: jnp.tanh,
            ir.NativeFunction.ARCSINH: jnp.arcsinh,
            ir.NativeFunction.ARCCOSH: jnp.arccosh,
            ir.NativeFunction.ARCTANH: jnp.arctanh,
            ir.NativeFunction.SQRT: jnp.sqrt,
            ir.NativeFunction.EXP: jnp.exp,
            ir.NativeFunction.LOG: jnp.log,
            ir.NativeFunction.LOG10: jnp.log10,
            ir.NativeFunction.LOG2: jnp.log2,
            ir.NativeFunction.GAMMA: gamma,
            ir.NativeFunction.CBRT: jnp.cbrt,
            ir.NativeFunction.ISFINITE: jnp.isfinite,
            ir.NativeFunction.ISINF: jnp.isinf,
            ir.NativeFunction.ISNAN: jnp.isnan,
            ir.NativeFunction.FLOOR: jnp.floor,
            ir.NativeFunction.CEIL: jnp.ceil,
            ir.NativeFunction.TRUNC: jnp.trunc,
            ir.NativeFunction.ROUND: jnp.round,
            ir.NativeFunction.ROUND_AWAY_FROM_ZERO: round_away_from_zero,
            ir.NativeFunction.ERF: jsp.erf,
            ir.NativeFunction.ERFC: jsp.erfc,
            ir.NativeFunction.POW: jnp.power,
        }
    )


class _ScanIneligible(Exception):
    """Section cannot use the lax.scan fast path; fall back to fori_loop."""


def _xs_name(name: str, dk: int) -> str:
    return f"{name}__xs[{dk}]"


def _carry_name(name: str, depth: int) -> str:
    return f"{name}__carry[{depth}]"


def _needs_old_plane_seed(body, name: str) -> bool:
    """True if the pre-sweep plane value of `name` can be observed in the
    section: a dk==0 read, or a masked write, before the first unconditional
    whole-plane write."""
    state = {"definite": False, "needs": False}

    def check_expr(expr):
        if state["definite"] or state["needs"]:
            return
        for acc in ir.field_accesses(expr):
            if (
                acc.name == name
                and isinstance(acc.offset, ir.CartesianOffset)
                and acc.offset.k == 0
            ):
                state["needs"] = True
                return

    def walk(stmts, masked):
        for stmt in stmts:
            if state["needs"]:
                return
            if isinstance(stmt, ir.Assign):
                if not state["definite"]:
                    check_expr(stmt.value)
                    for d in stmt.target.data_index:
                        check_expr(d)
                    if stmt.target.name == name:
                        if masked or stmt.target.data_index:
                            state["needs"] = True
                        else:
                            state["definite"] = True
            elif isinstance(stmt, ir.If):
                if not state["definite"]:
                    check_expr(stmt.cond)
                walk(stmt.body, True)
                walk(stmt.orelse, True)
            elif isinstance(stmt, ir.While):
                if not state["definite"]:
                    check_expr(stmt.cond)
                walk(stmt.body, True)
            elif isinstance(stmt, ir.HorizontalRestriction):
                walk(stmt.body, True)

    walk(body, False)
    return state["needs"]


def _rewrite_section_for_planes(body, written, const_fields, backward: bool,
                                stream_specs=None):
    """Clone the section body, renaming K-offset field accesses to plane
    buffers: behind-the-sweep reads -> carry planes, ahead/old reads ->
    scan-input planes (or the stream's history carries), current planes
    keep their name."""
    import copy as _copy

    stream_specs = stream_specs or {}
    out = []
    # frontends may legally ALIAS an IR node into several expression
    # positions (the bridge's scan lowering does); deepcopy preserves the
    # aliasing, so the mutating rename below must visit each OBJECT once
    # -- a second visit would stack suffixes ('__out__carry[1]__xs[0]',
    # bridge fuzz seed 10008) and the plane env has no such key
    seen: set = set()
    for stmt in body:
        cloned = _copy.deepcopy(stmt)
        for node in ir.walk_values(cloned):
            if isinstance(node, ir.Assign):
                t = node.target
                if t.name in const_fields:
                    raise _ScanIneligible()
                t.offset = ir.CartesianOffset(t.offset.i, t.offset.j, 0)
        for node in ir.walk_values(cloned):
            if not isinstance(node, ir.FieldAccess):
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            off = node.offset
            if not isinstance(off, ir.CartesianOffset):
                raise _ScanIneligible()
            dk = off.k
            name = node.name
            if name in const_fields:
                new_name = name
            elif name in written:
                behind = (dk > 0) if backward else (dk < 0)
                if dk == 0:
                    new_name = name
                elif behind:
                    new_name = _carry_name(name, abs(dk))
                else:
                    new_name = _xs_name(name, dk)
            elif name in stream_specs:
                dref, _depth = stream_specs[name]
                if dk == dref:
                    new_name = _xs_name(name, dref)
                else:
                    d = (dk - dref) if backward else (dref - dk)
                    new_name = _carry_name(name, d)
            else:
                new_name = _xs_name(name, dk)
            node.name = new_name
            node.offset = ir.CartesianOffset(off.i, off.j, 0)
        out.append((stmt, cloned))
    return out


class JaxTracer:
    """Traces the stencil IR into jnp operations on an env of buffers."""

    serial_k_value = None  # set per-plane inside the lax.scan fast path

    def __init__(self, analysis: StencilAnalysis, meta: Dict[str, _FieldMeta], domain):
        if not _NATIVE_JNP:
            _init_native_jnp()
        self.analysis = analysis
        self.stencil = analysis.stencil
        self.meta = meta
        self.domain = domain

    # ------------------------------------------------------------------ #

    def trace(self, env: Dict[str, Any], scalars: Dict[str, Any]) -> Dict[str, Any]:
        """env: full 3D(+data) jnp buffers by name.  Returns updated env."""
        self.scalars = scalars
        # temporaries get metas up-front but buffers lazily: temps that live
        # entirely inside one serial scan never touch device memory (the
        # analog of the reference's LocalTemporariesToScalars / K-cache passes,
        # gtc/passes/oir_optimizations/{temporaries,caches}.py)
        for name, decl in self.stencil.temp_decls.items():
            ext = self.analysis.extents.alloc_extent(name)
            shape = (
                self.domain[0] - ext.i[0] + ext.i[1],
                self.domain[1] - ext.j[0] + ext.j[1],
                self.domain[2] - ext.k[0] + ext.k[1],
            ) + tuple(decl.data_dims)
            self.meta[name] = _FieldMeta(
                shape=shape,
                origin=(-ext.i[0], -ext.j[0], -ext.k[0]),
                dtype=np.dtype(decl.dtype),
                dimensions=(True, True, True),
                data_ndim=len(decl.data_dims),
            )
        self._temp_section_count = self._count_temp_sections()

        for li, loop in enumerate(self.stencil.vertical_loops):
            env = self._trace_loop(env, loop, li)
        return env

    def _count_temp_sections(self) -> Dict[str, int]:
        """How many vertical sections access each temporary."""
        counts: Dict[str, int] = {}
        self._temp_last_read: Dict[str, Tuple[int, int]] = {}
        for li, loop in enumerate(self.stencil.vertical_loops):
            for si, section in enumerate(loop.sections):
                names = set()
                for stmt in section.body:
                    for n in ir.walk_values(stmt):
                        if not isinstance(n, ir.FieldAccess):
                            continue
                        if n.name not in self.stencil.temp_decls:
                            continue
                        names.add(n.name)
                        is_write = isinstance(stmt, ir.Assign) and n is stmt.target
                        if not is_write:
                            self._temp_last_read[n.name] = (li, si)
                for n in names:
                    counts[n] = counts.get(n, 0) + 1
        return counts

    def _stmt_ext(self, stmt) -> Extent:
        """Statement compute extent."""
        return self.analysis.extents.stmt_extent(stmt)

    def _temp_read_after(self, name: str, pos: Tuple[int, int]) -> bool:
        """Is the temporary read in any section at or after ``pos``
        *other than through the scan's own planes*?  (Used to elide dead
        buffer writebacks.)"""
        last = getattr(self, "_temp_last_read", {}).get(name)
        return last is not None and last > pos

    def _ensure_buffer(self, env, name: str):
        """Materialize a lazily-allocated temporary buffer."""
        if name in env:
            return env
        import jax.numpy as jnp

        m = self.meta[name]
        env = dict(env)
        env[name] = jnp.zeros(_phys_shape(m.shape), dtype=m.dtype)
        return env

    def _trace_loop(self, env, loop: ir.VerticalLoop, loop_index: int = 0):
        import jax

        dK = self.domain[2]
        for si, section in enumerate(loop.sections):
            k0, k1 = section.interval.resolve(dK, self.scalars)
            k0, k1 = max(k0, 0), min(k1, dK)
            if k1 <= k0:
                continue
            if loop.loop_order == ir.LoopOrder.PARALLEL:
                for stmt in section.body:
                    ctx = _TraceCtx(self, self._stmt_ext(stmt), kslice=(k0, k1))
                    env = self._trace_stmt(env, stmt, ctx)
            else:
                backward = loop.loop_order == ir.LoopOrder.BACKWARD
                n = k1 - k0

                if n > 1:
                    try:
                        env = self._trace_serial_scan(
                            env, section, (k0, k1), backward, (loop_index, si)
                        )
                        continue
                    except _ScanIneligible:
                        pass

                # stable fori carry: materialize written temps up front
                for name in ir.assigned_names(section.body):
                    if name in self.stencil.temp_decls:
                        env = self._ensure_buffer(env, name)

                def body(i, env, _k0=k0, _k1=k1, _bwd=backward, _section=section):
                    k = (_k1 - 1 - i) if _bwd else (_k0 + i)
                    for stmt in _section.body:
                        ctx = _TraceCtx(self, self._stmt_ext(stmt), klevel=k)
                        env = self._trace_stmt(env, stmt, ctx)
                    return env

                if n == 1:
                    env = body(0, env)
                else:
                    env = jax.lax.fori_loop(0, n, body, env)
        return env

    # ---------------- serial-K lax.scan fast path ---------------- #
    #
    # FORWARD/BACKWARD sections lower to lax.scan over K-leading plane
    # stacks: reads of not-yet-written planes become pre-shifted scan
    # inputs, reads of already-written planes become scan carries, and the
    # written planes are stacked scan outputs.  This is the XLA form
    # of the reference's serial K loop (oir.VerticalLoop / the embedded
    # ScanOperator, reference: src/gt4py/next/embedded/operators.py:40-90):
    # per-level work is a fused whole-IJ-plane kernel and XLA pipelines the
    # K sweep without per-level dynamic-slice round trips to HBM.

    def _trace_serial_scan(self, env, section, krange, backward: bool,
                           pos=(0, 0)):
        import jax
        import jax.numpy as jnp

        k0, k1 = krange
        n = k1 - k0

        written = set(ir.assigned_names(section.body))
        # fields without a K axis are per-sweep constants (closure-captured)
        const_fields = {
            name
            for node in ir.walk_values(section.body)
            if isinstance(node, ir.FieldAccess)
            for name in [node.name]
            if self.meta[name].shape[2] == 1
        }
        if const_fields & written:
            raise _ScanIneligible()
        # classify accesses; raises _ScanIneligible on unsupported patterns
        xs_specs, carry_specs, stream_specs = self._classify_serial_accesses(
            section, written, const_fields, backward
        )

        # Liveness: temporaries accessed only in this section (and with no
        # ahead-of-sweep reads) never need an HBM buffer -- their planes live
        # in the scan carry/step only.  Written fields whose first touch is
        # an unconditional whole-plane write don't need an old-value seed.
        temp_counts = getattr(self, "_temp_section_count", {})
        local_written = {
            name
            for name in written
            if temp_counts.get(name, 99) == 1
            and name not in env
            and not any(n == name for (n, dk) in xs_specs if dk != 0)
        }

        # per-field union of writing-statement extents: the writeback region
        per_field_write_ext: Dict[str, Extent] = {}
        for stmt in section.body:
            sext = self.analysis.extents.stmt_extent(stmt)
            for w in ir.walk_values(stmt):
                if isinstance(w, ir.Assign):
                    cur = per_field_write_ext.get(w.target.name)
                    per_field_write_ext[w.target.name] = (
                        sext if cur is None else (cur | sext)
                    )

        def _definite_write_covers(name: str) -> bool:
            """Does the first unconditional write's extent cover the whole
            writeback region?  If not, the uncovered ring would read the
            unseeded plane (zeros) and clobber old halo values."""
            wext = per_field_write_ext.get(name, Extent.zeros())
            for stmt in section.body:
                if isinstance(stmt, ir.Assign) and stmt.target.name == name:
                    dext = self.analysis.extents.stmt_extent(stmt)
                    return (
                        dext.i[0] <= wext.i[0]
                        and dext.i[1] >= wext.i[1]
                        and dext.j[0] <= wext.j[0]
                        and dext.j[1] >= wext.j[1]
                    )
            return False

        for name in written:
            if name in local_written or (
                not _needs_old_plane_seed(section.body, name)
                and _definite_write_covers(name)
            ):
                xs_specs.discard((name, 0))

        plane_metas: Dict[str, _FieldMeta] = {}

        def plane_meta(name: str) -> _FieldMeta:
            m = self.meta[name]
            return _FieldMeta(
                shape=(m.shape[0], m.shape[1], 1) + m.shape[3:],
                origin=(m.origin[0], m.origin[1], 0),
                dtype=m.dtype,
                dimensions=m.dimensions,
                data_ndim=m.data_ndim,
            )

        # --- scan inputs: contiguous plane slices off the K-leading axis --- #
        xs = {}
        for (name, dk) in sorted(xs_specs):
            buf = env.get(name)
            if buf is None:  # unallocated temporary: old values are zeros
                m = self.meta[name]
                buf = jnp.zeros(_phys_shape(m.shape), dtype=m.dtype)
            ok = self.meta[name].origin[2]
            sl = buf[ok + k0 + dk : ok + k1 + dk]  # (n, SI, SJ, *dd) -- no copy
            stack = sl[:, None]  # per-step plane keeps its singleton K axis
            if backward:
                stack = stack[::-1]
            xs[_xs_name(name, dk)] = stack
            plane_metas[_xs_name(name, dk)] = plane_meta(name)

        ks = jnp.arange(k0, k1, dtype=jnp.int32)
        xs["__k"] = ks[::-1] if backward else ks

        # --- carry init: planes "behind" the sweep start --- #
        carry0 = {}
        for name, depths in sorted(carry_specs.items()):
            m = self.meta[name]
            ok = m.origin[2]
            SK = m.shape[2]
            for d in sorted(depths):
                k_abs = (ok + k1 - 1 + d) if backward else (ok + k0 - d)
                if 0 <= k_abs < SK and name in env:
                    plane = env[name][k_abs : k_abs + 1]
                else:
                    plane = jnp.zeros(
                        (1, m.shape[0], m.shape[1]) + m.shape[3:], dtype=m.dtype
                    )
                carry0[_carry_name(name, d)] = plane
                plane_metas[_carry_name(name, d)] = plane_meta(name)

        # stream history carries: carry[d] at step k holds plane k+dref-d
        # (forward; mirrored backward), seeded from the buffer
        for name, (dref, depth) in sorted(stream_specs.items()):
            m = self.meta[name]
            ok = m.origin[2]
            SK = m.shape[2]
            for d in range(1, depth + 1):
                k_abs = (
                    (ok + (k1 - 1) + dref + d) if backward else (ok + k0 + dref - d)
                )
                if 0 <= k_abs < SK and name in env:
                    plane = env[name][k_abs : k_abs + 1]
                else:
                    plane = jnp.zeros(
                        (1, m.shape[0], m.shape[1]) + m.shape[3:], dtype=m.dtype
                    )
                carry0[_carry_name(name, d)] = plane
                plane_metas[_carry_name(name, d)] = plane_meta(name)

        for name in written:
            plane_metas[name] = plane_meta(name)
        for name in const_fields:
            plane_metas[name] = self.meta[name]

        rewritten = _rewrite_section_for_planes(
            section.body, written, const_fields, backward, stream_specs
        )

        extents = self.analysis.extents
        saved_meta = self.meta
        dI, dJ, _ = self.domain

        const_bufs = {name: env[name] for name in const_fields}
        seeded = {name for name in written if (name, 0) in xs_specs}

        def step(carry, x):
            plane_env = dict(carry)
            plane_env.update({k: v for k, v in x.items() if k != "__k"})
            plane_env.update(const_bufs)
            # current planes of written fields start as their old values
            # (or zeros when the old value is provably unobservable)
            for name in written:
                if name in seeded:
                    plane_env[name] = x[_xs_name(name, 0)]
                else:
                    m = plane_metas[name]
                    plane_env[name] = jnp.zeros(_phys_shape(m.shape), dtype=m.dtype)

            sub = JaxTracer.__new__(JaxTracer)
            sub.analysis = self.analysis
            sub.stencil = self.stencil
            sub.meta = plane_metas
            sub.domain = (dI, dJ, 1)
            sub.scalars = self.scalars
            sub.serial_k_value = x["__k"]

            e = plane_env
            for orig_stmt, stmt in rewritten:
                ctx = _TraceCtx(sub, extents.stmt_extent(orig_stmt), kslice=(0, 1))
                e = sub._trace_stmt(e, stmt, ctx)

            new_carry = {}
            for name, depths in carry_specs.items():
                for d in sorted(depths):
                    if d == 1:
                        new_carry[_carry_name(name, 1)] = e[name]
                    else:
                        new_carry[_carry_name(name, d)] = carry[_carry_name(name, d - 1)]
            for name, (dref, depth) in stream_specs.items():
                for d in range(1, depth + 1):
                    if d == 1:
                        new_carry[_carry_name(name, 1)] = x[_xs_name(name, dref)]
                    else:
                        new_carry[_carry_name(name, d)] = carry[_carry_name(name, d - 1)]
            ys = {name: e[name] for name in written if name not in local_written}
            return new_carry, ys

        _, ys = jax.lax.scan(step, carry0, xs)

        # per-field write region (computed above): unseeded planes are zero
        # outside it, so the writeback must not clobber halo points beyond it
        write_ext = per_field_write_ext

        env = dict(env)
        for name in written - local_written:
            if name in self.stencil.temp_decls and not self._temp_read_after(name, pos):
                continue  # dead store: nothing reads this temp's buffer later
            env = self._ensure_buffer(env, name)
            stack = ys[name]  # (n, 1, SI, SJ, *dd)
            if backward:
                stack = stack[::-1]
            planes = jnp.squeeze(stack, axis=1)  # (n, SI, SJ, *dd)
            m = self.meta[name]
            oi, oj, ok = m.origin
            ext = write_ext.get(name, Extent.zeros())
            i0, i1 = oi + ext.i[0], oi + dI + ext.i[1]
            j0, j1 = oj + ext.j[0], oj + dJ + ext.j[1]
            buf = env[name]
            # contiguous K-leading writeback of the computed region only
            env[name] = buf.at[ok + k0 : ok + k1, i0:i1, j0:j1].set(
                planes[:, i0:i1, j0:j1].astype(buf.dtype)
            )
        self.meta = saved_meta
        return env

    def _classify_serial_accesses(self, section, written, const_fields, backward: bool):
        """Collect (name, dk) scan-input specs and carry depths per field.

        Raises _ScanIneligible for patterns the scan path cannot express
        (variable/absolute K, non-zero K offsets on assignment targets).
        """
        xs_specs = set()
        carry_specs: Dict[str, set] = {}
        for node in ir.walk_values(section.body):
            if isinstance(node, ir.Assign):
                off = node.target.offset
                if not isinstance(off, ir.CartesianOffset) or off.k != 0:
                    raise _ScanIneligible()
            if isinstance(node, ir.FieldAccess):
                off = node.offset
                if not isinstance(off, ir.CartesianOffset):
                    raise _ScanIneligible()
                dk = off.k
                name = node.name
                if name in const_fields:
                    continue
                if name not in written:
                    xs_specs.add((name, dk))
                else:
                    behind = (dk > 0) if backward else (dk < 0)
                    if dk == 0:
                        pass  # current plane, seeded from xs(name, 0)
                    elif behind:
                        carry_specs.setdefault(name, set()).add(abs(dk))
                    else:
                        xs_specs.add((name, dk))
        # carries must be contiguous depths 1..D for the shift-register update
        for name, depths in carry_specs.items():
            depth = max(depths)
            carry_specs[name] = set(range(1, depth + 1))
        # every written field needs its old current plane
        for name in written:
            xs_specs.add((name, 0))

        # Stream optimization: an unwritten field read at several K offsets
        # needs only ONE materialized plane stream (the sweep-forward-most
        # offset); the other offsets are that stream's recent history, kept
        # in a carry shift register instead of extra HBM stacks.
        stream_specs: Dict[str, Tuple[int, int]] = {}  # name -> (dref, max_depth)
        by_name: Dict[str, set] = {}
        for (name, dk) in xs_specs:
            if name not in written:
                by_name.setdefault(name, set()).add(dk)
        for name, dks in by_name.items():
            if len(dks) < 2:
                continue
            dref = min(dks) if backward else max(dks)
            depth = max((dref - dk) if not backward else (dk - dref) for dk in dks)
            for dk in dks:
                if dk != dref:
                    xs_specs.discard((name, dk))
            stream_specs[name] = (dref, depth)
        return xs_specs, carry_specs, stream_specs

    # ------------------- statements ------------------- #

    def _trace_stmt(self, env, stmt: ir.Stmt, ctx: _TraceCtx):
        if isinstance(stmt, ir.Assign):
            return self._trace_assign(env, stmt, ctx)
        if isinstance(stmt, ir.If):
            return self._trace_if(env, stmt, ctx)
        if isinstance(stmt, ir.While):
            return self._trace_while(env, stmt, ctx)
        if isinstance(stmt, ir.HorizontalRestriction):
            return self._trace_horizontal(env, stmt, ctx)
        raise TypeError(f"Unknown statement {type(stmt).__name__}")

    def _select(self, cond, t, f):
        import jax.numpy as jnp

        return jnp.where(cond, t, f)

    def _trace_assign(self, env, stmt: ir.Assign, ctx: _TraceCtx):
        import jax.numpy as jnp

        if stmt.target.name in getattr(self, "_temp_section_count", {}):
            env = self._ensure_buffer(env, stmt.target.name)
        value = self._eval(env, stmt.value, ctx)
        name = stmt.target.name
        meta = self.meta[name]
        rhs = jnp.asarray(value)
        if rhs.dtype != meta.dtype:
            rhs = rhs.astype(meta.dtype)

        old, write_back = self._read_region(env, stmt.target, ctx, for_write=True)
        rhs = jnp.broadcast_to(rhs, old.shape)
        if ctx.masks:
            mask = ctx.masks[0]
            for m in ctx.masks[1:]:
                mask = jnp.logical_and(mask, m)
            if mask.ndim and mask.ndim < old.ndim:
                mask = mask.reshape(mask.shape + (1,) * (old.ndim - mask.ndim))
            rhs = self._select(mask, rhs, old)
        env = dict(env)
        env[name] = write_back(env.get(name), rhs)
        return env

    def _trace_if(self, env, stmt: ir.If, ctx: _TraceCtx):
        import jax.numpy as jnp

        cond = self._eval(env, stmt.cond, ctx)
        cond = jnp.asarray(cond).astype(bool)
        ctx.masks.append(cond)
        for s in stmt.body:
            env = self._trace_stmt(env, s, ctx)
        ctx.masks.pop()
        if stmt.orelse:
            ctx.masks.append(jnp.logical_not(cond))
            for s in stmt.orelse:
                env = self._trace_stmt(env, s, ctx)
            ctx.masks.pop()
        return env

    def _trace_while(self, env, stmt: ir.While, ctx: _TraceCtx):
        import jax
        import jax.numpy as jnp

        # temporaries first assigned inside the loop must exist before the
        # carry structure is fixed
        for name in ir.assigned_names(stmt.body):
            if name in self.stencil.temp_decls:
                env = self._ensure_buffer(env, name)

        mask0 = jnp.broadcast_to(
            jnp.asarray(self._eval(env, stmt.cond, ctx)).astype(bool), ctx.shape()
        )
        # points excluded by enclosing if/region masks must not keep the
        # loop alive (their condition can never change)
        for m in ctx.masks:
            mask0 = jnp.logical_and(
                mask0, jnp.broadcast_to(jnp.asarray(m, dtype=bool), ctx.shape())
            )

        def cond_fn(carry):
            env_c, mask = carry
            return jnp.any(mask)

        def body_fn(carry):
            env_c, mask = carry
            ctx.masks.append(mask)
            for s in stmt.body:
                env_c = self._trace_stmt(env_c, s, ctx)
            ctx.masks.pop()
            new_mask = jnp.logical_and(
                mask,
                jnp.broadcast_to(
                    jnp.asarray(self._eval(env_c, stmt.cond, ctx)).astype(bool),
                    ctx.shape(),
                ),
            )
            return (env_c, new_mask)

        env, _ = jax.lax.while_loop(cond_fn, body_fn, (env, mask0))
        return env

    def _trace_horizontal(self, env, stmt: ir.HorizontalRestriction, ctx: _TraceCtx):
        import jax.numpy as jnp

        dI, dJ, _ = self.domain
        gI, gJ = dI, dJ
        i_glob = jnp.arange(
            ctx.ext.i[0], dI + ctx.ext.i[1], dtype=jnp.int32
        ).reshape(1, -1, 1)
        j_glob = jnp.arange(
            ctx.ext.j[0], dJ + ctx.ext.j[1], dtype=jnp.int32
        ).reshape(1, 1, -1)
        mask = jnp.zeros((1, ctx.ni, ctx.nj), dtype=bool)
        for m in stmt.masks:
            ilo, ihi = m.i.resolve(gI)
            jlo, jhi = m.j.resolve(gJ)
            mask = mask | (
                (i_glob >= ilo) & (i_glob < ihi) & (j_glob >= jlo) & (j_glob < jhi)
            )
        mask = jnp.broadcast_to(mask, ctx.shape())
        ctx.masks.append(mask)
        for s in stmt.body:
            env = self._trace_stmt(env, s, ctx)
        ctx.masks.pop()
        return env

    # ------------------- region access ------------------- #

    def _region_spec(self, meta: _FieldMeta, off: ir.CartesianOffset, ctx: _TraceCtx):
        """Return (starts, sizes) of the accessed region in the full buffer.

        The K start may be a traced value in serial sections.
        """
        dI, dJ, _ = self.domain
        oi, oj, ok = meta.origin
        if meta.shape[0] == 1:
            i0, ni = 0, 1
        else:
            i0, ni = oi + ctx.ext.i[0] + off.i, ctx.ni
        if meta.shape[1] == 1:
            j0, nj = 0, 1
        else:
            j0, nj = oj + ctx.ext.j[0] + off.j, ctx.nj
        if meta.shape[2] == 1:
            k0, nk = 0, 1
        elif ctx.klevel is not None:
            k0, nk = ok + ctx.klevel + off.k, 1
        else:
            k0, nk = ok + ctx.kslice[0] + off.k, ctx.nk
        return (i0, j0, k0), (ni, nj, nk)

    def _read_region(self, env, acc: ir.FieldAccess, ctx: _TraceCtx, for_write=False):
        """Read the accessed region; if for_write, also return a writeback fn."""
        import jax
        import jax.numpy as jnp

        name = acc.name
        meta = self.meta[name]
        buf = env.get(name)
        buf_missing = buf is None
        if buf_missing:  # unwritten temporary (dead code)
            if not for_write and isinstance(acc.offset, ir.CartesianOffset):
                (_, _, _), (ni, nj, nk) = self._region_spec(meta, acc.offset, ctx)
                region = jnp.zeros((nk, ni, nj) + meta.shape[3:], dtype=meta.dtype)
                if acc.data_index:
                    region = self._apply_data_index(env, region, acc, ctx)
                return region, None
        off = acc.offset
        if not isinstance(off, ir.CartesianOffset):
            if for_write:
                raise NotImplementedError("Non-Cartesian write offsets")
            if buf_missing:
                env = dict(env)
                env[name] = jnp.zeros(_phys_shape(meta.shape), dtype=meta.dtype)
            return self._read_nonuniform_k(env, acc, ctx), None

        (i0, j0, k0), (ni, nj, nk) = self._region_spec(meta, off, ctx)
        data_shape = meta.shape[3:]

        dyn_k = not isinstance(k0, int)
        if buf_missing:
            # write path of a never-written buffer: the "old" region is
            # zeros (only consumed by masked writes); sized to the region,
            # not the buffer, so dead-code lowering stays cheap
            idx = (slice(k0, k0 + nk), slice(i0, i0 + ni), slice(j0, j0 + nj))
            region = jnp.zeros((nk, ni, nj) + data_shape, dtype=meta.dtype)
        elif not dyn_k:
            idx = (slice(k0, k0 + nk), slice(i0, i0 + ni), slice(j0, j0 + nj))
            region = buf[idx]
        else:
            starts = (k0, i0, j0) + (0,) * len(data_shape)
            sizes = (nk, ni, nj) + data_shape
            region = jax.lax.dynamic_slice(buf, starts, sizes)

        from gt4py_tpu.cartesian.analysis import try_static_int

        didx = ()
        dynamic_write = False
        if acc.data_index:
            if for_write and all(
                try_static_int(d) is not None for d in acc.data_index
            ):
                didx = tuple(
                    self._data_index_value(env, d, ctx) for d in acc.data_index
                )
                region = region[(slice(None), slice(None), slice(None)) + didx]
            elif for_write:
                # per-point component write: the "current value" is the
                # gathered component; write_back one-hot-selects over the
                # data axes (modulo wrap, mirroring the read path)
                dynamic_write = True
                region = self._apply_data_index(env, region, acc, ctx)
            else:
                region = self._apply_data_index(env, region, acc, ctx)

        if not for_write:
            return region, None

        phys = _phys_shape(meta.shape)

        def write_back(buf, value):
            if (
                not acc.data_index
                and not dyn_k
                and value.shape == tuple(phys)
                and value.dtype == meta.dtype
            ):
                # full-cover write: the new value IS the buffer (no
                # dynamic_update_slice copy)
                return value
            if buf is None:  # lazily-absent value temp, partial write
                buf = jnp.zeros(phys, dtype=meta.dtype)
            if acc.data_index:
                # write one component: read-modify-write the full region
                if not dyn_k:
                    full = buf[idx]
                else:
                    full = jax.lax.dynamic_slice(buf, starts, sizes)
                if dynamic_write:
                    sel = self._data_onehot(env, acc, ctx, full.shape)
                    v = jnp.reshape(
                        value, value.shape + (1,) * (full.ndim - value.ndim)
                    )
                    full = self._select(sel, jnp.broadcast_to(v, full.shape), full)
                else:
                    full = full.at[
                        (slice(None), slice(None), slice(None)) + didx
                    ].set(value)
                value = full
            if not dyn_k:
                # dynamic_update_slice, not .at[].set (a scatter)
                static_starts = (k0, i0, j0) + (0,) * len(data_shape)
                return jax.lax.dynamic_update_slice(buf, value, static_starts)
            return jax.lax.dynamic_update_slice(buf, value, starts)

        return region, write_back

    def _read_nonuniform_k(self, env, acc: ir.FieldAccess, ctx: _TraceCtx):
        import jax.numpy as jnp

        meta = self.meta[acc.name]
        buf = env.get(acc.name)
        if buf is None:
            # unwritten temporary (dead code): zeros region directly
            (_, _, _), (ni, nj, _) = self._region_spec(
                meta, ir.CartesianOffset(), ctx
            )
            region = jnp.zeros((ctx.nk, ni, nj) + meta.shape[3:], dtype=meta.dtype)
            if acc.data_index:
                region = self._apply_data_index(env, region, acc, ctx)
            return region
        off = acc.offset
        SK = meta.shape[2]
        ok = meta.origin[2]

        (i0, j0, _), (ni, nj, _) = self._region_spec(meta, ir.CartesianOffset(), ctx)

        import jax

        if isinstance(off, ir.VariableKOffset):
            dk = jnp.asarray(self._eval(env, off.k, ctx)).astype(jnp.int32)
            if ctx.klevel is not None:
                base = jnp.asarray(ok + ctx.klevel, dtype=jnp.int32)
            else:
                kk0, kk1 = ctx.kslice
                base = (ok + jnp.arange(kk0, kk1, dtype=jnp.int32)).reshape(-1, 1, 1)
            kidx = jnp.clip(base + dk, 0, SK - 1)
        else:  # AbsoluteKIndex
            kval = jnp.asarray(self._eval(env, off.k, ctx)).astype(jnp.int32)
            kidx = jnp.clip(kval + ok, 0, SK - 1)

        kidx = jnp.asarray(kidx)
        if kidx.ndim == 0:
            kidx = kidx.reshape(1, 1, 1)
        kidx = jnp.broadcast_to(kidx, (ctx.nk, ni, nj))
        block = buf[:, slice(i0, i0 + ni), slice(j0, j0 + nj)]
        out = jnp.take_along_axis(block, kidx, axis=0)

        if acc.data_index:
            out = self._apply_data_index(env, out, acc, ctx)
        return out

    def _data_index_value(self, env, expr: ir.Expr, ctx: _TraceCtx):
        from gt4py_tpu.cartesian.analysis import try_static_int

        v = try_static_int(expr)
        if v is None:
            raise NotImplementedError("Non-static data-dimension write indices")
        return v

    def _data_onehot(self, env, acc: ir.FieldAccess, ctx: _TraceCtx, shape):
        """Boolean (nk, ni, nj, *dd) mask selecting each point's component
        (dynamic data-index writes; modulo wrap like the read path)."""
        import jax.numpy as jnp

        dd = shape[3:]
        n = len(dd)
        sel = jnp.ones((1, 1, 1) + (1,) * n, dtype=bool)
        for ax, expr in enumerate(acc.data_index):
            iota = jnp.arange(dd[ax], dtype=jnp.int32).reshape(
                (1, 1, 1) + (1,) * ax + (dd[ax],) + (1,) * (n - ax - 1)
            )
            iv = jnp.asarray(self._eval(env, expr, ctx)).astype(jnp.int32)
            if iv.ndim == 0:
                iv = iv.reshape((1, 1, 1) + (1,) * n)
            elif iv.ndim == 3:
                iv = iv.reshape(iv.shape + (1,) * n)
            else:
                raise NotImplementedError("Data index must be scalar or per-point")
            sel = sel & (iota == (iv % dd[ax]))
        return sel

    def _apply_data_index(self, env, region, acc: ir.FieldAccess, ctx: _TraceCtx):
        """Consume the trailing data axes of ``region`` (shape
        (nk, ni, nj, *data_dims)); static int indices slice, per-point
        (dynamic) int indices gather along the data axis (reference:
        gtc/common.py:390-398 -- data_index is any int expression)."""
        import jax
        import jax.numpy as jnp

        from gt4py_tpu.cartesian.analysis import try_static_int

        grid = (slice(None), slice(None), slice(None))
        for expr in acc.data_index:
            v = try_static_int(expr)
            if v is not None:
                region = region[grid + (v,)]
                continue
            idx = jnp.asarray(self._eval(env, expr, ctx)).astype(jnp.int32)
            if idx.ndim == 0:
                region = jax.lax.dynamic_index_in_dim(
                    region, idx % region.shape[3], axis=3, keepdims=False
                )
                continue
            if idx.ndim != 3:
                raise NotImplementedError("Data index must be scalar or per-point")
            rem = region.ndim - 4
            # modulo wrap: uniform dynamic-index semantics on all backends
            idx = idx % region.shape[3]
            idx_exp = jnp.reshape(idx, idx.shape + (1,) * (rem + 1))
            import numpy as _np

            shape = _np.broadcast_shapes(
                idx_exp.shape, region.shape[:3] + (1,) + region.shape[4:]
            )
            gathered = jnp.take_along_axis(
                jnp.broadcast_to(region, shape[:3] + region.shape[3:]),
                jnp.broadcast_to(idx_exp, shape),
                axis=3,
            )
            region = jnp.reshape(gathered, gathered.shape[:3] + gathered.shape[4:])
        return region

    # ------------------- expressions ------------------- #

    def _eval(self, env, expr: ir.Expr, ctx: _TraceCtx):
        import jax.numpy as jnp

        if isinstance(expr, ir.Literal):
            if expr.dtype is not None:
                return jnp.asarray(expr.value, dtype=expr.dtype)
            if isinstance(expr.value, bool):
                return jnp.asarray(expr.value, dtype=bool)
            if isinstance(expr.value, int):
                return jnp.asarray(expr.value, dtype=default_int_dtype(self.stencil))
            return jnp.asarray(expr.value, dtype=default_float_dtype(self.stencil))

        if isinstance(expr, ir.ScalarAccess):
            decl = self.stencil.scalar_decls[expr.name]
            return jnp.asarray(self.scalars[expr.name], dtype=decl.dtype)

        if isinstance(expr, ir.FieldAccess):
            region, _ = self._read_region(env, expr, ctx)
            return region

        if isinstance(expr, ir.AxisPosition):
            dI, dJ, _ = self.domain
            dt = default_int_dtype(self.stencil)
            if expr.axis == "K" and self.serial_k_value is not None:
                return jnp.asarray(self.serial_k_value, dtype=dt)
            # physical (K, I, J) broadcasting
            if expr.axis == "I":
                return jnp.arange(
                    ctx.ext.i[0], dI + ctx.ext.i[1], dtype=dt
                ).reshape(1, -1, 1)
            if expr.axis == "J":
                return jnp.arange(
                    ctx.ext.j[0], dJ + ctx.ext.j[1], dtype=dt
                ).reshape(1, 1, -1)
            if ctx.klevel is not None:
                return jnp.asarray(ctx.klevel, dtype=dt)
            return jnp.arange(ctx.kslice[0], ctx.kslice[1], dtype=dt).reshape(-1, 1, 1)

        if isinstance(expr, ir.AxisSize):
            return jnp.asarray(
                {"I": self.domain[0], "J": self.domain[1], "K": self.domain[2]}[expr.axis],
                dtype=default_int_dtype(self.stencil),
            )

        if isinstance(expr, ir.Cast):
            return jnp.asarray(self._eval(env, expr.expr, ctx)).astype(expr.dtype)

        if isinstance(expr, ir.UnaryOp):
            v = self._eval(env, expr.expr, ctx)
            if expr.op == ir.UnaryOperator.NOT:
                return jnp.logical_not(v)
            if expr.op == ir.UnaryOperator.NEG:
                return jnp.negative(v)
            return v

        if isinstance(expr, ir.BinaryOp):
            left = jnp.asarray(self._eval(env, expr.left, ctx))
            right = jnp.asarray(self._eval(env, expr.right, ctx))
            if expr.op == ir.BinaryOperator.AND:
                return jnp.logical_and(left, right)
            if expr.op == ir.BinaryOperator.OR:
                return jnp.logical_or(left, right)
            target = promote_dtypes(np.dtype(left.dtype), np.dtype(right.dtype))
            if left.dtype != target:
                left = left.astype(target)
            if right.dtype != target:
                right = right.astype(target)
            return _apply_binop_jnp(expr.op, left, right)

        if isinstance(expr, ir.TernaryOp):
            cond = jnp.asarray(self._eval(env, expr.cond, ctx))
            t = jnp.asarray(self._eval(env, expr.true_expr, ctx))
            f = jnp.asarray(self._eval(env, expr.false_expr, ctx))
            target = promote_dtypes(np.dtype(t.dtype), np.dtype(f.dtype))
            return self._select(cond, t.astype(target), f.astype(target))

        if isinstance(expr, ir.NativeFuncCall):
            args = [jnp.asarray(self._eval(env, a, ctx)) for a in expr.args]
            if len(args) > 1:
                target = promote_dtypes(*[np.dtype(a.dtype) for a in args])
                args = [a.astype(target) if a.dtype != target else a for a in args]
            return _NATIVE_JNP[expr.func](*args)

        raise TypeError(f"Cannot trace {type(expr).__name__}")


def _to_logical(buf, user_shape):
    """Physical (K, I, J, *dd) buffer -> user-shaped logical array."""
    import jax.numpy as jnp

    buf = jnp.transpose(buf, (1, 2, 0) + tuple(range(3, buf.ndim)))
    return buf.reshape(user_shape)


def _apply_binop_jnp(op: ir.BinaryOperator, left, right):
    import jax.numpy as jnp

    table = {
        ir.BinaryOperator.ADD: jnp.add,
        ir.BinaryOperator.SUB: jnp.subtract,
        ir.BinaryOperator.MUL: jnp.multiply,
        ir.BinaryOperator.DIV: jnp.true_divide,
        ir.BinaryOperator.FLOOR_DIV: jnp.floor_divide,
        ir.BinaryOperator.MOD: jnp.mod,
        ir.BinaryOperator.POW: jnp.power,
        ir.BinaryOperator.EQ: jnp.equal,
        ir.BinaryOperator.NE: jnp.not_equal,
        ir.BinaryOperator.LT: jnp.less,
        ir.BinaryOperator.LE: jnp.less_equal,
        ir.BinaryOperator.GT: jnp.greater,
        ir.BinaryOperator.GE: jnp.greater_equal,
        ir.BinaryOperator.BIT_AND: jnp.bitwise_and,
        ir.BinaryOperator.BIT_OR: jnp.bitwise_or,
        ir.BinaryOperator.BIT_XOR: jnp.bitwise_xor,
    }
    return table[op](left, right)


@register("jax")
class JaxBackend:
    """Traced XLA executor.  Returns updated arrays for written fields."""

    def __init__(self, analysis: StencilAnalysis, options: Optional[dict] = None):
        config.ensure_jax_config()  # x64 etc. before any tracing
        self.options = options or {}
        if not self.options.get("no_inline", False):
            from gt4py_tpu.cartesian import analysis as analysis_mod
            from gt4py_tpu.cartesian.passes import inline_parallel_temporaries

            optimized = inline_parallel_temporaries(analysis.stencil)
            if len(optimized.temp_decls) != len(analysis.stencil.temp_decls):
                analysis = analysis_mod.analyze(optimized)
        self.analysis = analysis
        self._programs: Dict[Any, Callable] = {}
        self.written = [
            name
            for name, info in analysis.field_info.items()
            if info.access.value & 2  # WRITE
        ]
        self.runtime_bound_names = {
            b.name
            for loop in self.analysis.stencil.vertical_loops
            for section in loop.sections
            for b in (section.interval.start, section.interval.end)
            if isinstance(b, ir.RuntimeAxisBound)
        }

    # ------------------------------------------------------------------ #

    def _program_key(self, metas: Dict[str, _FieldMeta], domain, scalar_dtypes):
        return (
            tuple(sorted((n, m.shape, m.origin, str(m.dtype)) for n, m in metas.items())),
            tuple(domain),
            tuple(sorted((n, str(d)) for n, d in scalar_dtypes.items())),
        )

    def _periodic_fill_env(self, metas, env, domain, periodic, only=None):
        """Periodic execution semantics: before the stencil runs, the I/J
        halos of every field read with nonzero horizontal extent are filled
        from the opposite interior edge (width = that field's read extent).
        Models with periodic boundaries then need no explicit fill passes
        between chained stencils (the pallas backend fills the same way
        before its kernels)."""
        dI, dJ, _ = domain
        ext = self.analysis.extents
        new_env = dict(env)
        for name, m in metas.items():
            if only is not None and name not in only:
                continue
            e = ext.field_extent(name)
            hi0, hi1 = -e.i[0], e.i[1]
            hj0, hj1 = -e.j[0], e.j[1]
            a = new_env[name]
            oi, oj, _ok = m.origin
            if "I" in periodic and m.shape[0] != 1 and (hi0 or hi1):
                if dI < max(hi0, hi1):
                    raise ValueError(
                        f"periodic I domain ({dI}) smaller than the read "
                        f"halo of field '{name}' ({max(hi0, hi1)})"
                    )
                if hi0:
                    a = a.at[:, oi - hi0 : oi].set(a[:, oi + dI - hi0 : oi + dI])
                if hi1:
                    a = a.at[:, oi + dI : oi + dI + hi1].set(a[:, oi : oi + hi1])
            if "J" in periodic and m.shape[1] != 1 and (hj0 or hj1):
                if dJ < max(hj0, hj1):
                    raise ValueError(
                        f"periodic J domain ({dJ}) smaller than the read "
                        f"halo of field '{name}' ({max(hj0, hj1)})"
                    )
                if hj0:
                    a = a.at[:, :, oj - hj0 : oj].set(a[:, :, oj + dJ - hj0 : oj + dJ])
                if hj1:
                    a = a.at[:, :, oj + dJ : oj + dJ + hj1].set(a[:, :, oj : oj + hj1])
            new_env[name] = a
        return new_env

    def _trace_env(self, metas, env, scalars, domain, periodic=()):
        """Execute the stencil on an env of physical buffers (overridable:
        the pallas backend lowers to column kernels here)."""
        if periodic:
            env = self._periodic_fill_env(metas, env, domain, periodic)
        tracer = JaxTracer(self.analysis, dict(metas), tuple(domain))
        return tracer.trace(dict(env), dict(scalars))

    def _build_program(self, metas: Dict[str, _FieldMeta], domain, static_bounds=None,
                       periodic=()):
        jax = _jax()

        written = [n for n in self.written if n in metas]
        static_bounds = dict(static_bounds or {})

        def program(written_arrays, read_arrays, scalars):
            env = {**read_arrays, **written_arrays}
            env = self._trace_env(
                metas, env, {**scalars, **static_bounds}, domain, periodic
            )
            return {n: env[n] for n in written}

        donate = (0,) if config.DONATE_BUFFERS else ()
        return jax.jit(program, donate_argnums=donate)

    def apply(self, arrays, scalars, domain, origins, physical_layout=False,
              periodic=()):
        """Functionally apply the stencil: traceable under an outer jit.

        ``arrays`` are jnp arrays (or tracers); returns a dict of updated
        arrays for written fields.  This is the composition entry used by
        models and benchmarks to fuse multiple stencils into one XLA program.

        With ``physical_layout=True`` the caller passes and receives full
        K-leading (K, I, J, *dd) buffers (the executor's native layout) --
        chained stencils then compose with zero transposes.

        ``periodic`` ("I", "J", or both): reads beyond the domain wrap
        periodically (see ``_periodic_fill_env``).
        """
        import jax.numpy as jnp

        metas, full_bufs = self._prepare(
            arrays, origins, as_device=False, physical_in=physical_layout
        )
        env = self._trace_env(metas, full_bufs, scalars, tuple(domain), periodic)
        out = {}
        for name in self.written:
            if name in full_bufs:
                if physical_layout:
                    out[name] = env[name]
                else:
                    out[name] = _to_logical(env[name], arrays[name].shape)
        return out

    def _prepare(self, arrays, origins, as_device=True, physical_in=False):
        """Reshape user arrays to full physical (K, I, J, *dd) buffers and
        build logical metas."""
        import jax.numpy as jnp

        metas: Dict[str, _FieldMeta] = {}
        full_bufs: Dict[str, Any] = {}
        for name, arr in arrays.items():
            decl = self.analysis.stencil.field_decls[name]
            data_ndim = len(decl.data_dims)
            buf = jnp.asarray(arr) if as_device else arr
            if physical_in:
                shape = list(buf.shape)
                logical = (shape[1], shape[2], shape[0]) + tuple(shape[3:])
                o = origins[name]
                full_origin3 = tuple(o) + (0,) * (3 - len(o))
                full_bufs[name] = buf
                metas[name] = _FieldMeta(
                    shape=logical,
                    origin=full_origin3,
                    dtype=np.dtype(decl.dtype),
                    dimensions=decl.dimensions,
                    data_ndim=data_ndim,
                )
                continue
            shape = list(buf.shape)
            spatial = len(shape) - data_ndim
            full_shape: List[int] = []
            full_origin: List[int] = []
            it = iter(range(spatial))
            for present in decl.dimensions:
                if present:
                    ax = next(it)
                    full_shape.append(shape[ax])
                    full_origin.append(origins[name][ax] if ax < len(origins[name]) else 0)
                else:
                    full_shape.append(1)
                    full_origin.append(0)
            full_shape.extend(shape[spatial:])
            buf = jnp.reshape(buf, full_shape)
            # physical K-leading layout (see _phys_shape)
            buf = jnp.transpose(buf, (2, 0, 1) + tuple(range(3, buf.ndim)))
            full_bufs[name] = buf
            metas[name] = _FieldMeta(
                shape=tuple(full_shape),
                origin=tuple(full_origin),
                dtype=np.dtype(decl.dtype),
                dimensions=decl.dimensions,
                data_ndim=data_ndim,
            )
        return metas, full_bufs

    def run(self, arrays, scalars, domain, origins, exec_info=None, periodic=()):
        jax = _jax()

        metas, full_bufs = self._prepare(arrays, origins)

        scalar_vals = {
            name: scalars[name]
            for name in self.analysis.parameter_info
            if scalars.get(name) is not None
        }
        # runtime interval bounds are baked into the trace (one compiled
        # variant per bound value, like domain/origin specialization)
        static_bounds = {
            n: int(scalar_vals.pop(n))
            for n in sorted(self.runtime_bound_names)
            if n in scalar_vals
        }
        key = self._program_key(
            metas, domain, {n: np.asarray(v).dtype for n, v in scalar_vals.items()}
        ) + (tuple(sorted(static_bounds.items())), tuple(sorted(periodic)))
        if key not in self._programs:
            self._programs[key] = self._build_program(
                metas, domain, static_bounds, periodic
            )
        program = self._programs[key]

        if exec_info is not None:
            exec_info["run_start_time"] = time.perf_counter()

        written_in = {n: full_bufs[n] for n in self.written if n in full_bufs}
        read_in = {n: b for n, b in full_bufs.items() if n not in written_in}
        out = program(written_in, read_in, scalar_vals)

        if exec_info is not None:
            jax.block_until_ready(out)
            exec_info["run_end_time"] = time.perf_counter()

        # transpose back from physical (K, I, J) and drop size-1 axes
        result = {}
        for name, buf in out.items():
            result[name] = _to_logical(buf, arrays[name].shape)
        return result

"""Pallas backend: stencils as column kernels on Pallas' Triton route.

The design follows the reference's GPU backend (GridTools ``gt:gpu``):

- **Grid.**  A parallel grid of (BI, BJ) blocks tiles the IJ compute
  domain.  BI and BJ are powers of two, J is the contiguous axis of the
  physical (K, I, J) layout, and ragged domain edges are masked: every
  load and store carries a bounds mask.  Blocks run in any order.
- **K loop.**  Each program walks K itself in an in-kernel
  ``lax.fori_loop`` (a *sweep*).  In FORWARD/BACKWARD sweeps the planes a
  sweep reads behind itself are loop carries held in registers (the
  K-cache); in PARALLEL sweeps K offsets are loads of shifted planes.
- **Horizontal offsets** are masked loads of the shifted window straight
  from device memory; L1/L2 supply the reuse.
- **Temporaries** read only at the same point stay SSA values of the plane
  and never touch memory.  The XLA path's inlining pass runs first, so
  most horizontally-offset temporaries disappear into their readers.
- **Stages.**  Blocks cannot see each other's writes inside one kernel, so
  a statement that reads at a horizontal offset a field written earlier
  in the same kernel (or writes one read so) starts a new kernel.  Fields
  and temporaries crossing a stage boundary live in device memory.
- **Scalars** are plain operands.

Which stencils take the kernel is one rule, the same on every platform
(:func:`kernel_class` and :data:`KERNEL_CLASSES`); the rest run on the
XLA executor through the visible fallback (``FALLBACK_EVENTS``,
``config.warn_fallback``), as does any stencil the kernel cannot express
or the Triton lowering refuses.  Interpret mode is used only on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Tuple

import numpy as np

from gt4py_tpu import config
from gt4py_tpu.cartesian import ir
from gt4py_tpu.cartesian.backend import register
from gt4py_tpu.cartesian.backend.jax_backend import (
    JaxBackend,
    JaxTracer,
    _FieldMeta,
    _phys_shape,
)
from gt4py_tpu.core.definitions import F16_DTYPES, Extent
from gt4py_tpu.core.events import EventLog


class _PallasIneligible(Exception):
    pass


#: (stencil_name, reason) per XLA fallback -- observability for tests
#: asserting the kernel path ran (a bitwise-equal result alone cannot
#: distinguish the paths).  Bounded; diff with FALLBACK_EVENTS.cursor() /
#: .since() (trim-stable); .total is monotonic.
FALLBACK_EVENTS: EventLog = EventLog()

#: stencil_name -> the last kernel plan (stages, sweeps, block shape) --
#: lets tests assert WHICH kernel form ran, not just that results match
LAST_PLAN: dict = {}

#: Stencil classes (see :func:`kernel_class`) sent to the column kernel.
#: Measured on an H100 SXM (see README "Measured performance"): the kernel
#: wins where a serial-K sweep would otherwise be one XLA launch per level;
#: all-PARALLEL stencils are left to XLA's own fusion.
KERNEL_CLASSES = frozenset({"serial"})
ALL_CLASSES = frozenset({"serial", "parallel"})


def kernel_class(stencil: ir.Stencil) -> str:
    """``"serial"`` if any vertical loop is FORWARD/BACKWARD, else
    ``"parallel"``."""
    for loop in stencil.vertical_loops:
        if loop.loop_order != ir.LoopOrder.PARALLEL:
            return "serial"
    return "parallel"


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Block shape and Triton launch parameters of one stage."""

    bi: int
    bj: int
    num_warps: int
    num_stages: int


def plan_blocks(ni: int, nj: int, itemsize: int = 4) -> BlockPlan:
    """Block shape for an ``ni`` x ``nj`` compute region.

    J rows of 64 elements (256 B at f32: two 128-byte transactions; 32
    for 8-byte types), at most 512 points per block, each dimension a
    power of two no larger than the region needs."""
    bj = min(_pow2_ceil(nj), 64 if itemsize <= 4 else 32)
    bi = min(_pow2_ceil(ni), max(1, 512 // bj))
    num_warps = 4 if bi * bj >= 256 else (2 if bi * bj >= 64 else 1)
    return BlockPlan(bi=bi, bj=bj, num_warps=num_warps, num_stages=2)


# --------------------------------------------------------------------------- #
# Stage / sweep planning (pure IR analysis)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class Sweep:
    """One in-kernel K loop over [k0, k1) running ``stmts`` per plane,
    each over its horizontal compute extent ``exts``."""

    order: ir.LoopOrder
    k0: int
    k1: int
    stmts: List[ir.Stmt]
    exts: List[Extent]

    @property
    def backward(self) -> bool:
        return self.order == ir.LoopOrder.BACKWARD


@dataclasses.dataclass
class Stage:
    """The sweeps of one kernel launch and their horizontal extent."""

    sweeps: List[Sweep]
    ext: Extent


def _accesses(stmts) -> Tuple[List[ir.FieldAccess], List[ir.FieldAccess]]:
    """(reads, writes) of a statement list; targets are writes only."""
    from gt4py_tpu.cartesian.analysis import _stmt_reads, _stmt_writes

    reads, writes = [], []
    for s in stmts:
        reads.extend(_stmt_reads(s))
        writes.extend(_stmt_writes(s))
    return reads, writes


def _is_cartesian(acc) -> bool:
    return isinstance(acc.offset, ir.CartesianOffset)


def _hoff(acc) -> bool:
    """Read at a horizontal offset."""
    return _is_cartesian(acc) and bool(acc.offset.i or acc.offset.j)


def _koff(acc) -> bool:
    """Read at another level: a K offset, variable or absolute."""
    return not _is_cartesian(acc) or bool(acc.offset.k)


def _check_offsets(reads, writes) -> None:
    for acc in reads + writes:
        if acc.data_index:
            raise _PallasIneligible("data-dimension index")
    for w in writes:
        o = w.offset
        if not _is_cartesian(w) or o.i or o.j or o.k:
            raise _PallasIneligible("offset write")


def plan_stages(stencil: ir.Stencil, extents, dK: int, scalars) -> List[Stage]:
    """Split the stencil into kernel launches (stages) and K loops (sweeps).

    A serial section is one sweep and never splits.  Consecutive PARALLEL
    statements of one interval share a sweep unless one reads at a K
    offset a name another writes.  A unit that reads at a horizontal
    offset a name written earlier in the stage, or writes a name read so
    earlier in the stage, starts a new stage: blocks cannot see each
    other's writes inside one launch.  A PARALLEL horizontal region is
    one unit per statement of its body (each over the region's extent),
    so a region reading its own earlier write at an offset splits too."""
    units = []  # (order, k0, k1, [stmts], [extents])
    for loop in stencil.vertical_loops:
        for section in loop.sections:
            try:
                k0, k1 = section.interval.resolve(dK, scalars)
            except Exception as e:  # traced runtime bound
                raise _PallasIneligible("runtime interval bound") from e
            k0, k1 = max(k0, 0), min(k1, dK)
            if k1 <= k0:
                continue
            if loop.loop_order != ir.LoopOrder.PARALLEL:
                exts = [extents.stmt_extent(s) for s in section.body]
                units.append((loop.loop_order, k0, k1, list(section.body), exts))
                continue
            for stmt in section.body:
                ext = extents.stmt_extent(stmt)
                parts = [stmt]
                if isinstance(stmt, ir.HorizontalRestriction) and len(stmt.body) > 1:
                    parts = [ir.HorizontalRestriction(stmt.masks, [b]) for b in stmt.body]
                for part in parts:
                    units.append((loop.loop_order, k0, k1, [part], [ext]))

    stages: List[Stage] = []
    st_written: set = set()
    st_hread: set = set()
    sw_written: set = set()
    sw_kread: set = set()
    for order, k0, k1, stmts, exts in units:
        reads, writes = _accesses(stmts)
        _check_offsets(reads, writes)
        w_names = {w.name for w in writes}
        h_reads = {r.name for r in reads if _hoff(r)}
        k_reads = {r.name for r in reads if _koff(r)}
        if h_reads & w_names:
            # a unit reading its own writes at a horizontal offset needs
            # its neighbours' columns mid-launch
            raise _PallasIneligible("horizontal read of a unit's own write")
        if w_names & {r.name for r in reads if not _is_cartesian(r)}:
            # a gather over the column being swept: loads could be
            # pipelined ahead of the stores they depend on
            raise _PallasIneligible("variable-K read of a swept field")
        ext = Extent.zeros()
        for e in exts:
            ext = ext | e
        new_stage = not stages or (h_reads & st_written) or (w_names & st_hread)
        if new_stage:
            stages.append(Stage(sweeps=[], ext=ext))
            st_written, st_hread = set(), set()
        stage = stages[-1]
        stage.ext = stage.ext | ext
        last = stage.sweeps[-1] if stage.sweeps and not new_stage else None
        join = (
            last is not None
            and order == ir.LoopOrder.PARALLEL
            and last.order == ir.LoopOrder.PARALLEL
            and (last.k0, last.k1) == (k0, k1)
            and not (k_reads & (sw_written | w_names))
            and not (w_names & sw_kread)
        )
        if join:
            last.stmts.extend(stmts)
            last.exts.extend(exts)
        else:
            stage.sweeps.append(Sweep(order, k0, k1, list(stmts), list(exts)))
            sw_written, sw_kread = set(), set()
        sw_written |= w_names
        sw_kread |= k_reads
        st_written |= w_names
        st_hread |= h_reads
    return stages


def _written_first(stmts, name: str) -> bool:
    """Is the first statement mentioning ``name`` an unconditional
    assignment to it that does not read it?"""
    for s in stmts:
        if not any(
            isinstance(n, ir.FieldAccess) and n.name == name
            for n in ir.walk_values(s)
        ):
            continue
        return (
            isinstance(s, ir.Assign)
            and s.target.name == name
            and all(a.name != name for a in ir.field_accesses(s.value))
        )
    return False


def plan_storage(stencil: ir.Stencil, stages: List[Stage]):
    """Classify names: ``values`` (temporaries that never need device
    memory: SSA plane values) and per-sweep ``carries``
    {id(sweep): {name: depth}} (planes a serial sweep reads behind itself:
    K-cache registers).

    A temporary is a value when it is read only at its own point, except
    for the planes a serial sweep carries, and either lives in one sweep
    or is written first, unconditionally, in every sweep that touches it
    (the plane-local rule of ``passes.plane_local_temps``)."""
    sweeps = [sw for st in stages for sw in st.sweeps]
    touching: Dict[str, List[Sweep]] = {}
    bad: set = set()
    carried: set = set()
    for sw in sweeps:
        reads, writes = _accesses(sw.stmts)
        for name in {a.name for a in reads + writes}:
            touching.setdefault(name, []).append(sw)
        for r in reads:
            if not _is_cartesian(r) or _hoff(r):
                bad.add(r.name)
                continue
            behind = (r.offset.k > 0) if sw.backward else (r.offset.k < 0)
            if r.offset.k and not (sw.order != ir.LoopOrder.PARALLEL and behind):
                bad.add(r.name)
            elif r.offset.k:
                carried.add(r.name)

    def is_value(n):
        sws = touching.get(n, [])
        if n in bad:
            return False
        if len(sws) <= 1:
            return True
        return n not in carried and all(_written_first(sw.stmts, n) for sw in sws)

    values = frozenset(n for n in stencil.temp_decls if is_value(n))
    carries: Dict[int, Dict[str, int]] = {}
    for sw in sweeps:
        if sw.order == ir.LoopOrder.PARALLEL:
            continue
        reads, writes = _accesses(sw.stmts)
        w_names = {w.name for w in writes}
        depth: Dict[str, int] = {}
        for r in reads:
            if not _is_cartesian(r) or _hoff(r) or r.name not in w_names:
                continue
            dk = -r.offset.k if not sw.backward else r.offset.k
            if dk > 0:
                depth[r.name] = max(depth.get(r.name, 0), dk)
        carries[id(sw)] = depth
    return values, carries


# --------------------------------------------------------------------------- #
# In-kernel tracer
# --------------------------------------------------------------------------- #


def _within(a: Extent, b: Extent) -> bool:
    """Is horizontal extent ``a`` inside ``b``?"""
    return (
        a.i[0] >= b.i[0] and a.i[1] <= b.i[1]
        and a.j[0] >= b.j[0] and a.j[1] <= b.j[1]
    )


class _BlockCtx:
    """Trace context of one statement unit on one (1, BI, BJ) plane block."""

    def __init__(self, exe, ext: Extent):
        self.exe = exe
        self.ext = ext
        self.klevel = exe.k
        self.kslice = None
        self.masks: List[Any] = []
        self.store_mask = exe._ext_mask(ext)  # block points the unit computes

    ni = property(lambda self: self.exe.bi)
    nj = property(lambda self: self.exe.bj)
    nk = 1

    def shape(self):
        return (1, self.exe.bi, self.exe.bj)


class _ColumnTracer(JaxTracer):
    """Evaluates statement units on one plane block inside the kernel.

    ``refs`` maps every name living in device memory to its Pallas ref
    (written names: the output ref, aliased to the input buffer).
    ``plane`` holds the values assigned at the current level, ``carry``
    the K-cache planes behind the sweep."""

    def __init__(self, analysis, meta, domain, refs, bi, bj, g0):
        super().__init__(analysis, meta, domain)
        self.refs = refs
        self.bi, self.bj = bi, bj
        self.gi0, self.gj0 = g0  # block origin in domain coordinates
        self.k = None
        self.plane: Dict[str, Any] = {}
        self.plane_ext: Dict[str, Extent] = {}
        self.carry: Dict[str, List[Any]] = {}
        self.backward = False

    # ---- indexing ---- #

    def _iota(self, axis):
        import jax
        import jax.numpy as jnp

        shape = (1, self.bi, 1) if axis == 1 else (1, 1, self.bj)
        return jax.lax.broadcasted_iota(jnp.int32, shape, axis)

    def block_ij(self):
        """Domain-coordinate (i, j) index blocks of this program."""
        return self.gi0 + self._iota(1), self.gj0 + self._iota(2)

    def _ext_mask(self, ext: Extent):
        """Block points inside the domain grown by ``ext``."""
        i, j = self.block_ij()
        dI, dJ, _ = self.domain
        return (
            (i >= ext.i[0]) & (i < dI + ext.i[1])
            & (j >= ext.j[0]) & (j < dJ + ext.j[1])
        )

    def _window(self, name, di, dj, k):
        """Per-point int32 (k, i, j) index blocks of ``name`` at level ``k``
        (a scalar or a per-point block) shifted by (di, dj), and the mask
        of points inside the buffer (None: all are).  Size-1 axes
        broadcast.  Indices are not yet made safe for masked lanes."""
        import jax.numpy as jnp

        m = self.meta[name]
        si, sj, sk = m.shape[:3]
        oi, oj, ok = m.origin
        shape = (1, self.bi, self.bj)
        i, j = self.block_ij()
        mask = None
        idx = [jnp.broadcast_to(jnp.clip(k + ok, 0, sk - 1), shape)]
        for pos, size, org in ((i + di, si, oi), (j + dj, sj, oj)):
            if size == 1:
                idx.append(jnp.zeros(shape, jnp.int32))
                continue
            p = jnp.broadcast_to(pos + org, shape)
            inside = (p >= 0) & (p < size)
            mask = inside if mask is None else (mask & inside)
            idx.append(p)
        return [x.astype(jnp.int32) for x in idx], mask

    def load(self, name, di, dj, k):
        """Masked load; masked lanes read a clipped in-buffer address."""
        import jax.numpy as jnp
        from jax.experimental.pallas import triton as plgpu

        idx, mask = self._window(name, di, dj, k)
        shape = self.meta[name].shape
        idx = [jnp.clip(x, 0, n - 1) for x, n in zip(idx, (shape[2],) + shape[:2])]
        ref = self.refs[name].at[tuple(idx)]
        if mask is None:
            v = plgpu.load(ref)
        else:
            v = plgpu.load(ref, mask=mask, other=0)
        return v != 0 if self.meta[name].dtype == np.bool_ else v

    def store(self, name, value, k, store_mask):
        """Masked store; masked lanes address one past the buffer end, so
        no lane can alias an active one (the interpreter drops them)."""
        import jax.numpy as jnp
        from jax.experimental.pallas import triton as plgpu

        idx, mask = self._window(name, 0, 0, k)
        mask = store_mask if mask is None else (mask & store_mask)
        shape = self.meta[name].shape
        idx = [
            jnp.where(mask, x, n) for x, n in zip(idx, (shape[2],) + shape[:2])
        ]
        if value.dtype == np.bool_:
            value = value.astype(jnp.int8)
        plgpu.store(self.refs[name].at[tuple(idx)], value, mask=mask)

    # ---- tracer hooks ---- #

    def _gather_k(self, env, acc, ctx):
        """Per-point K read (variable offset or absolute index), clipped to
        the buffer like the other executors."""
        import jax.numpy as jnp

        kv = jnp.asarray(self._eval(env, acc.offset.k, ctx)).astype(jnp.int32)
        if isinstance(acc.offset, ir.VariableKOffset):
            kv = kv + self.k
        return self.load(acc.name, 0, 0, kv)

    def _read_region(self, env, acc, ctx, for_write=False):
        import jax.numpy as jnp

        name = acc.name
        if not _is_cartesian(acc):
            if name not in self.refs:
                return jnp.zeros(ctx.shape(), self.meta[name].dtype), None
            return self._gather_k(env, acc, ctx), None
        o = acc.offset
        if (o.i, o.j, o.k) == (0, 0, 0) and name in self.plane:
            val, ext = self.plane[name], self.plane_ext[name]
            if _within(ctx.ext, ext):
                return val, None
            # beyond the extent that computed the plane value, the point
            # holds what memory holds (zeros for a value temporary)
            if name in self.refs:
                other = self.load(name, 0, 0, self.k)
            else:
                other = jnp.zeros(ctx.shape(), val.dtype)
            return jnp.where(self._ext_mask(ext), val, other), None
        if not (o.i or o.j) and name in self.carry:
            d = o.k if self.backward else -o.k
            if 0 < d <= len(self.carry[name]):
                return self.carry[name][d - 1], None
        if name not in self.refs:  # value temp not yet assigned: zeros
            return jnp.zeros(ctx.shape(), self.meta[name].dtype), None
        return self.load(name, o.i, o.j, self.k + o.k), None

    def _trace_assign(self, env, stmt: ir.Assign, ctx):
        import jax.numpy as jnp

        name = stmt.target.name
        dtype = self.meta[name].dtype
        rhs = jnp.asarray(self._eval(env, stmt.value, ctx))
        if rhs.dtype != dtype:
            rhs = rhs.astype(dtype)
        rhs = jnp.broadcast_to(rhs, ctx.shape())
        if ctx.masks:
            mask = ctx.masks[0]
            for m in ctx.masks[1:]:
                mask = jnp.logical_and(mask, m)
            old, _ = self._read_region(env, stmt.target, ctx)
            rhs = self._select(mask, rhs, jnp.broadcast_to(old, ctx.shape()))
        ext = ctx.ext
        if name in self.plane and not _within(self.plane_ext[name], ext):
            # keep the earlier value where this statement does not reach
            rhs = jnp.where(ctx.store_mask, rhs, self.plane[name])
            ext = ext | self.plane_ext[name]
        self.plane[name] = rhs
        self.plane_ext[name] = ext
        if name in self.refs:
            self.store(name, rhs, self.k, ctx.store_mask)
        return env

    def _trace_while(self, env, stmt: ir.While, ctx):
        import jax
        import jax.numpy as jnp

        names = ir.assigned_names(stmt.body)
        for n in names:
            old, _ = self._read_region(
                env, ir.FieldAccess(name=n, offset=ir.CartesianOffset()), ctx
            )
            self.plane[n] = jnp.broadcast_to(old, ctx.shape())
            self.plane_ext[n] = ctx.ext

        def active(mask):
            cond = jnp.asarray(self._eval(env, stmt.cond, ctx)).astype(bool)
            mask = jnp.logical_and(mask, jnp.broadcast_to(cond, ctx.shape()))
            for m in ctx.masks:
                mask = jnp.logical_and(mask, m)
            return mask

        def body(carry):
            mask, vals = carry
            self.plane.update(zip(names, vals))
            ctx.masks.append(mask > 0)
            for s in stmt.body:
                self._trace_stmt(env, s, ctx)
            ctx.masks.pop()
            mask = active(mask > 0).astype(jnp.int32)
            return mask, tuple(self.plane[n] for n in names)

        mask0 = active(jnp.ones(ctx.shape(), bool)).astype(jnp.int32)
        _, vals = jax.lax.while_loop(
            lambda c: jnp.max(c[0]) > 0,
            body,
            (mask0, tuple(self.plane[n] for n in names)),
        )
        self.plane.update(zip(names, vals))
        return env

    def _trace_horizontal(self, env, stmt: ir.HorizontalRestriction, ctx):
        i, j = self.block_ij()
        dI, dJ, _ = self.domain
        mask = None
        for m in stmt.masks:
            ilo, ihi = m.i.resolve(dI)
            jlo, jhi = m.j.resolve(dJ)
            r = (i >= ilo) & (i < ihi) & (j >= jlo) & (j < jhi)
            mask = r if mask is None else (mask | r)
        ctx.masks.append(mask)
        for s in stmt.body:
            env = self._trace_stmt(env, s, ctx)
        ctx.masks.pop()
        return env

    def _eval(self, env, expr, ctx):
        import jax.numpy as jnp

        if isinstance(expr, ir.AxisPosition):
            from gt4py_tpu.cartesian.analysis import default_int_dtype

            dt = default_int_dtype(self.stencil)
            i, j = self.block_ij()
            pos = {"I": i, "J": j, "K": self.k}[expr.axis]
            return jnp.asarray(pos).astype(dt)
        if isinstance(expr, ir.NativeFuncCall):
            return self._native_call(env, expr, ctx)
        if (
            isinstance(expr, ir.UnaryOp)
            and expr.op == ir.UnaryOperator.NEG
            and isinstance(expr.expr, ir.Literal)
        ):
            # fold: the Triton lowering cannot negate a constant operand
            lit = expr.expr
            return super()._eval(env, ir.Literal(-lit.value, lit.dtype), ctx)
        return super()._eval(env, expr, ctx)

    def _native_call(self, env, expr, ctx):
        """Math functions; 16-bit arguments are computed in f32 and rounded
        back once, because libdevice has no 16-bit math (XLA's own sub-f32
        lowering does the same)."""
        import jax.numpy as jnp

        from gt4py_tpu.cartesian.analysis import promote_dtypes
        from gt4py_tpu.cartesian.backend.jax_backend import _NATIVE_JNP

        args = [jnp.asarray(self._eval(env, a, ctx)) for a in expr.args]
        target = promote_dtypes(*[np.dtype(a.dtype) for a in args])
        if len(args) > 1:
            args = [a.astype(target) if a.dtype != target else a for a in args]
        if target not in F16_DTYPES:
            return _NATIVE_JNP[expr.func](*args)
        out = _NATIVE_JNP[expr.func](*[a.astype(jnp.float32) for a in args])
        if np.dtype(out.dtype) == np.dtype(np.float32):
            return out.astype(target)
        return out  # isnan/isinf/isfinite keep their bool result

    # ---- sweeps ---- #

    def run_sweep(self, env, sweep: Sweep, depth: Dict[str, int]):
        import jax
        import jax.numpy as jnp

        self.backward = sweep.backward
        step = -1 if sweep.backward else 1
        first = sweep.k1 - 1 if sweep.backward else sweep.k0
        names = sorted(depth)
        sweep_ext = Extent.zeros()
        for e in sweep.exts:
            sweep_ext = sweep_ext | e

        def init(name, d):
            if name in self.refs:
                return self.load(name, 0, 0, jnp.int32(first - step * d))
            return jnp.zeros((1, self.bi, self.bj), self.meta[name].dtype)

        carry0 = tuple(
            tuple(init(n, d) for d in range(1, depth[n] + 1)) for n in names
        )

        def body(it, carry):
            self.k = jnp.int32(first) + step * it
            self.plane, self.plane_ext = {}, {}
            self.carry = dict(zip(names, [list(c) for c in carry]))
            for stmt, ext in zip(sweep.stmts, sweep.exts):
                self._trace_stmt(env, stmt, _BlockCtx(self, ext))
            # the carried plane must hold every point a reader may use
            ctx = _BlockCtx(self, sweep_ext)
            new = []
            for n, c in zip(names, carry):
                cur, _ = self._read_region(
                    env, ir.FieldAccess(name=n, offset=ir.CartesianOffset()), ctx
                )
                cur = jnp.broadcast_to(cur, (1, self.bi, self.bj))
                new.append((cur,) + tuple(c[:-1]))
            return tuple(new)

        n = sweep.k1 - sweep.k0
        jax.lax.fori_loop(jnp.int32(0), jnp.int32(n), body, carry0)
        self.plane, self.plane_ext, self.carry = {}, {}, {}


# --------------------------------------------------------------------------- #
# Backend
# --------------------------------------------------------------------------- #


@register("pallas")
class PallasBackend(JaxBackend):
    """Column kernels (Pallas, Triton route) with a visible XLA fallback."""

    def _trace_env(self, metas, env, scalars, domain, periodic=()):
        """Kernel path under a custom JVP: ``pallas_call`` itself is not
        differentiable, so tangents re-trace the stencil through the XLA
        executor (identical numerics).  custom_jvp supports both autodiff
        modes: jax.grad linearizes the jvp rule and transposes its
        (pure-XLA) tangent graph.  Traced scalar parameters participate in
        differentiation; python scalars are closed over as constants."""
        import jax

        written = [n for n in self.written if n in env]
        if not written:
            return dict(env)

        is_arr = lambda v: isinstance(v, jax.Array)  # tracers included
        arr_scalars = {k: v for k, v in scalars.items() if is_arr(v)}
        py_scalars = {k: v for k, v in scalars.items() if not is_arr(v)}

        def kernel_out(env_in, sc):
            out = self._trace_env_kernel(
                metas, dict(env_in), {**py_scalars, **sc}, domain, periodic
            )
            return {n: out[n] for n in written}

        def xla_out(env_in, sc):
            out = JaxBackend._trace_env(
                self, metas, dict(env_in), {**py_scalars, **sc}, domain, periodic
            )
            return {n: out[n] for n in written}

        run = jax.custom_jvp(kernel_out)

        @run.defjvp
        def _run_jvp(primals, tangents):
            out = kernel_out(*primals)
            _, tang = jax.jvp(xla_out, primals, tangents)
            return out, tang

        new_env = dict(env)
        new_env.update(run(env, arr_scalars))
        return new_env

    def _fallback(self, reason: str, metas, env, scalars, domain, periodic):
        name = self.analysis.stencil.name
        FALLBACK_EVENTS.record((name, reason))
        config.warn_fallback(f"stencil '{name}'", reason)
        if os.environ.get("GT4PY_TPU_PALLAS_DEBUG"):
            print(f"[pallas] {name}: XLA fallback: {reason}", flush=True)
        return JaxBackend._trace_env(self, metas, env, scalars, domain, periodic)

    def _trace_env_kernel(self, metas, env, scalars, domain, periodic=()):
        if any(m.data_ndim for m in metas.values()):
            out = self._trace_split_data_dims(metas, env, scalars, domain, periodic)
            if out is not None:
                return out
        cls = kernel_class(self.analysis.stencil)
        if cls not in KERNEL_CLASSES:
            return self._fallback(
                f"class rule: {cls} stencils run on XLA",
                metas, env, scalars, domain, periodic,
            )
        try:
            return self._pallas_trace(metas, env, scalars, tuple(domain), periodic)
        except _PallasIneligible as e:
            reason = str(e) or "ineligible"
            return self._fallback(reason, metas, env, scalars, domain, periodic)

    # ------------------------------------------------------------------ #

    def _split_child(self):
        """Backend over the component-split stencil (see
        passes.split_data_dims); None when the split does not apply."""
        if not hasattr(self, "_split_child_backend"):
            from gt4py_tpu.cartesian.analysis import analyze
            from gt4py_tpu.cartesian.passes import split_data_dims

            split = split_data_dims(self.analysis.stencil)
            self._split_child_backend = (
                PallasBackend(analyze(split), self.options) if split else None
            )
        return self._split_child_backend

    def _trace_split_data_dims(self, metas, env, scalars, domain, periodic):
        """Run data-dims stencils as kernels over per-component (K, I, J)
        buffers: the split happens outside the kernel (XLA slices/updates
        fuse with the surrounding program)."""
        import itertools

        from gt4py_tpu.cartesian.passes import component_name

        child = self._split_child()
        if child is None:
            return None

        decls = self.analysis.stencil.field_decls
        grid = (slice(None), slice(None), slice(None))
        env2, metas2 = {}, {}
        for name, m in metas.items():
            dd = decls[name].data_dims if name in decls else ()
            if not dd:
                env2[name] = env[name]
                metas2[name] = m
                continue
            for idx in itertools.product(*(range(d) for d in dd)):
                cname = component_name(name, idx)
                env2[cname] = env[name][grid + idx]
                metas2[cname] = _FieldMeta(
                    shape=m.shape[:3],
                    origin=m.origin,
                    dtype=m.dtype,
                    dimensions=m.dimensions,
                    data_ndim=0,
                )
        out_env = child._trace_env(metas2, env2, scalars, domain, periodic)
        result = dict(env)
        for name in self.written:
            if name not in metas:
                continue
            dd = decls[name].data_dims if name in decls else ()
            if not dd:
                result[name] = out_env[name]
                continue
            buf = env[name]
            for idx in itertools.product(*(range(d) for d in dd)):
                cname = component_name(name, idx)
                if cname in child.written:
                    buf = buf.at[grid + idx].set(out_env[cname])
            result[name] = buf
        return result

    # ------------------------------------------------------------------ #

    def _temp_metas(self, domain) -> Dict[str, _FieldMeta]:
        out = {}
        ext = self.analysis.extents
        for name, decl in self.analysis.stencil.temp_decls.items():
            if decl.data_dims:
                raise _PallasIneligible("temporary with data dimensions")
            e = ext.alloc_extent(name)
            out[name] = _FieldMeta(
                shape=(
                    domain[0] - e.i[0] + e.i[1],
                    domain[1] - e.j[0] + e.j[1],
                    domain[2] - e.k[0] + e.k[1],
                ),
                origin=(-e.i[0], -e.j[0], -e.k[0]),
                dtype=np.dtype(decl.dtype),
                dimensions=(True, True, True),
                data_ndim=0,
            )
        return out

    def plan(self, metas, domain, scalars=None):
        """The kernel plan for one call geometry: stages, storage classes
        and per-stage block plans (pure: no tracing)."""
        stencil = self.analysis.stencil
        dI, dJ, dK = domain
        for name in self.written:
            m = metas.get(name)
            if m is None:
                continue
            if (m.shape[0] == 1 and dI > 1) or (m.shape[1] == 1 and dJ > 1):
                raise _PallasIneligible("written field without an I or J axis")
        stages = plan_stages(stencil, self.analysis.extents, dK, scalars or {})
        if not stages:
            raise _PallasIneligible("empty stencil")
        values, carries = plan_storage(stencil, stages)
        itemsize = max(
            [np.dtype(m.dtype).itemsize for m in metas.values()]
            + [np.dtype(d.dtype).itemsize for d in stencil.temp_decls.values()]
            + [4]
        )
        blocks = []
        for st in stages:
            ni = dI - st.ext.i[0] + st.ext.i[1]
            nj = dJ - st.ext.j[0] + st.ext.j[1]
            blocks.append(plan_blocks(ni, nj, itemsize))
        return stages, values, carries, blocks

    def _pallas_trace(self, metas, env, scalars, domain, periodic=()):
        import jax

        if periodic:
            env = self._periodic_fill_env(metas, env, domain, periodic)
        stages, values, carries, blocks = self.plan(metas, domain, scalars)
        metas = {**metas, **self._temp_metas(domain)}
        env = dict(env)
        interpret = jax.devices()[0].platform == "cpu"
        for index, (stage, bp) in enumerate(zip(stages, blocks)):
            env = self._run_stage(
                index, stage, bp, metas, env, scalars, domain, values, carries,
                interpret,
            )
        LAST_PLAN[self.analysis.stencil.name] = {
            "stages": len(stages),
            "sweeps": [
                [(sw.order.name, sw.k0, sw.k1, len(sw.stmts)) for sw in st.sweeps]
                for st in stages
            ],
            "blocks": [(bp.bi, bp.bj) for bp in blocks],
            "values": sorted(values),
            "carries": sorted(
                {n for c in carries.values() for n in c}
            ),
        }
        return env

    def _run_stage(self, index, stage, bp, metas, env, scalars, domain, values,
                   carries, interpret):
        import jax
        import jax.numpy as jnp
        from jax.experimental import pallas as pl
        from jax.experimental.pallas import triton as plgpu

        reads, writes = _accesses([s for sw in stage.sweeps for s in sw.stmts])
        written = sorted({w.name for w in writes if w.name not in values})
        read_only = sorted(
            {r.name for r in reads if r.name not in values} - set(written)
        )
        for n in written + read_only:
            if n not in env:  # global temporary: zero-initialised buffer
                env[n] = jnp.zeros(_phys_shape(metas[n].shape), metas[n].dtype)
        arr_scalars = sorted(
            n for n, v in scalars.items() if isinstance(v, jax.Array)
        )
        dI, dJ, _ = domain
        ei, ej = stage.ext.i, stage.ext.j
        ni, nj = dI - ei[0] + ei[1], dJ - ej[0] + ej[1]
        grid = (pl.cdiv(ni, bp.bi), pl.cdiv(nj, bp.bj))
        analysis = self.analysis
        nw, nr = len(written), len(read_only)

        def kernel(*refs):
            in_refs = refs[: nw + nr]
            sc_refs = refs[nw + nr : nw + nr + len(arr_scalars)]
            out_refs = refs[nw + nr + len(arr_scalars) :]
            ref_map = dict(zip(read_only, in_refs[nw:]))
            ref_map.update(zip(written, out_refs))
            sc = dict(scalars)
            for n, r in zip(arr_scalars, sc_refs):
                sc[n] = plgpu.load(r)
            g0 = (
                ei[0] + pl.program_id(0) * bp.bi,
                ej[0] + pl.program_id(1) * bp.bj,
            )
            tr = _ColumnTracer(
                analysis, dict(metas), domain, ref_map, bp.bi, bp.bj, g0
            )
            tr.scalars = sc
            for sw in stage.sweeps:
                tr.run_sweep({}, sw, carries.get(id(sw), {}))

        # bool buffers travel as int8 (the kernel's memory type for them)
        operands = [_as_kernel_dtype(env[n]) for n in written + read_only]
        operands += [
            jnp.reshape(jnp.asarray(scalars[n]), (1, 1, 1)) for n in arr_scalars
        ]
        any_spec = pl.BlockSpec(memory_space=pl.ANY)

        def make_call(interp):
            return pl.pallas_call(
                kernel,
                out_shape=[
                    jax.ShapeDtypeStruct(o.shape, o.dtype)
                    for o in operands[:nw]
                ],
                grid=grid,
                in_specs=[any_spec] * len(operands),
                out_specs=[any_spec] * nw,
                input_output_aliases={i: i for i in range(nw)},
                backend="triton",
                compiler_params=plgpu.CompilerParams(
                    num_warps=bp.num_warps, num_stages=bp.num_stages
                ),
                interpret=interp,
                name=f"{analysis.stencil.name}_stage{index}",
            )

        _check_lowering(make_call(False), operands)
        outs = make_call(interpret)(*operands)
        env = dict(env)
        for n, o in zip(written, outs):
            env[n] = o.astype(env[n].dtype) if o.dtype != env[n].dtype else o
        return env


def _as_kernel_dtype(x):
    return x.astype(np.int8) if x.dtype == np.bool_ else x


def _check_lowering(call, operands) -> None:
    """Lower the kernel for CUDA before committing to it: a construct the
    Triton route cannot express becomes a visible fallback here, not a
    compile error of the caller's whole program later.  Lowering is pure
    Python (no device), so the CPU runs the same check."""
    import jax

    avals = [jax.ShapeDtypeStruct(np.shape(o), o.dtype) for o in operands]
    try:
        jax.jit(call).trace(*avals).lower(lowering_platforms=("cuda",))
    except Exception as e:  # noqa: BLE001 -- any lowering refusal
        msg = str(e).strip().splitlines()
        raise _PallasIneligible(
            "Triton lowering: " + (msg[0][:200] if msg else type(e).__name__)
        ) from e

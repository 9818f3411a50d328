"""Random stencil-program generator for differential backend testing.

Generates random *valid* GTScript-like programs directly as IR (bypassing
the frontend), runs them on the numpy oracle and the jax executor, and
compares.  This hunts semantic divergence the hand-written suites miss:
random offset patterns, section layouts, mask nesting, temp reuse.

The generator respects the parallel-model race rules by construction:
- API output fields are only written at zero offset and never read with
  horizontal offsets;
- in PARALLEL loops, written fields are not read at k offsets;
- temporaries are written before they are read (definitive assignment).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from gt4py_tpu.cartesian import ir

MAX_OFFSET = 2


class ProgramGenerator:
    def __init__(
        self,
        rng: random.Random,
        n_inputs: int = 3,
        n_outputs: int = 2,
        dtype=np.float64,
        allow_while: bool = True,
    ):
        self.rng = rng
        #: ``while`` loops compare against thresholds; at 16-bit dtypes a
        #: value within one ulp of the bound can round differently under
        #: the chip's excess-precision arithmetic than under the numpy
        #: oracle, flipping the ITERATION COUNT -- a divergence no
        #: tolerance can cover (chip bf16 fuzz seed 11).  Decision-
        #: boundary-sensitive legs disable whiles.
        self.allow_while = allow_while
        self.inputs = [f"in{i}" for i in range(n_inputs)]
        self.outputs = [f"out{i}" for i in range(n_outputs)]
        self.scalars = ["s0", "s1"]
        self.n_temps = 0
        self.dtype = np.dtype(dtype)

    # ------------------------------------------------------------------ #

    def generate(self) -> ir.Stencil:
        n_loops = self.rng.randint(1, 3)
        loops = []
        self.temps_assigned: List[str] = []
        for _ in range(n_loops):
            loops.append(self._gen_loop())

        field_decls = {
            name: ir.FieldDecl(name=name, dtype=self.dtype)
            for name in self.inputs + self.outputs
        }
        temp_decls = {
            name: ir.FieldDecl(name=name, dtype=self.dtype, is_api=False)
            for name in self.temps_assigned
        }
        params = [
            ir.ApiParam(name=n, is_field=True) for n in self.inputs + self.outputs
        ] + [
            ir.ApiParam(name=n, is_field=False, is_keyword=True)
            for n in self.scalars
        ]
        return ir.Stencil(
            name=f"fuzz_{self.rng.randint(0, 1 << 30)}",
            api_params=params,
            field_decls=field_decls,
            scalar_decls={
                n: ir.ScalarDecl(name=n, dtype=self.dtype) for n in self.scalars
            },
            temp_decls=temp_decls,
            vertical_loops=loops,
            literal_float_dtype=self.dtype,
        )

    # ------------------------------------------------------------------ #

    def _gen_loop(self) -> ir.VerticalLoop:
        order = self.rng.choice(
            [ir.LoopOrder.PARALLEL, ir.LoopOrder.FORWARD, ir.LoopOrder.BACKWARD]
        )
        n_sections = self.rng.randint(1, 2)
        if n_sections == 1:
            intervals = [ir.Interval.full()]
        else:
            split = self.rng.randint(1, 3)
            intervals = [
                ir.Interval(ir.AxisBound.start(), ir.AxisBound.start(split)),
                ir.Interval(ir.AxisBound.start(split), ir.AxisBound.end()),
            ]
            if order == ir.LoopOrder.BACKWARD:
                intervals.reverse()
        sections = []
        for iv in intervals:
            body = self._gen_section_body(order)
            sections.append(ir.VerticalSection(interval=iv, body=body))
        return ir.VerticalLoop(loop_order=order, sections=sections)

    def _gen_section_body(self, order) -> List[ir.Stmt]:
        serial = order != ir.LoopOrder.PARALLEL
        stmts: List[ir.Stmt] = []
        #: names written in this section (serial loops may read them back
        #: at "behind" offsets; PARALLEL only at zero offset)
        written_here: List[str] = []
        for _ in range(self.rng.randint(1, 4)):
            kind = self.rng.random()
            if kind < 0.6 or not written_here:
                stmt = self._gen_assign(order, written_here)
            elif kind < 0.8:
                cond = self._gen_expr(order, written_here, depth=1)
                cond = ir.BinaryOp(
                    op=ir.BinaryOperator.GT, left=cond, right=ir.Literal(value=0.5)
                )
                # conditional writes are NOT definitive: only outputs and
                # already-definitely-assigned temps may be targets, and
                # written_here must not gain new names
                body = [self._gen_assign(order, written_here, conditional=True)]
                orelse = (
                    [self._gen_assign(order, written_here, conditional=True)]
                    if self.rng.random() < 0.5
                    else []
                )
                stmt = ir.If(cond=cond, body=body, orelse=orelse)
            elif kind < 0.9 and self.temps_assigned and self.allow_while:
                # bounded pointwise while: increment a definitely-assigned
                # temp until it clears a nearby bound (terminates in <= ~4
                # iterations since fields start in [0, 1) plus a few ops)
                t = self.rng.choice(self.temps_assigned)
                cond = ir.BinaryOp(
                    op=ir.BinaryOperator.LT,
                    left=ir.FieldAccess(name=t),
                    right=ir.Literal(value=round(self.rng.uniform(0.5, 2.0), 3)),
                )
                body: List[ir.Stmt] = [
                    ir.Assign(
                        target=ir.FieldAccess(name=t),
                        value=ir.BinaryOp(
                            op=ir.BinaryOperator.ADD,
                            left=ir.FieldAccess(name=t),
                            right=ir.Literal(value=1.0),
                        ),
                    )
                ]
                if self.rng.random() < 0.5:
                    extra = self._gen_assign(order, written_here, conditional=True)
                    # the extra assign must not reset the loop counter below
                    # the bound (non-termination)
                    if extra.target.name != t:
                        body.append(extra)
                stmt = ir.While(cond=cond, body=body)
            else:
                # horizontal region: partial write, same rules as masked
                stmt = ir.HorizontalRestriction(
                    masks=[self._gen_hmask() for _ in range(self.rng.randint(1, 2))],
                    body=[self._gen_assign(order, written_here, conditional=True)],
                )
            stmts.append(stmt)
        # ensure at least one output is written somewhere
        if not any(
            isinstance(n, ir.Assign) and n.target.name in self.outputs
            for s in stmts
            for n in ir.walk_values(s)
        ):
            out = self.rng.choice(self.outputs)
            stmts.append(
                ir.Assign(
                    target=ir.FieldAccess(name=out),
                    value=self._gen_expr(order, written_here, depth=0),
                )
            )
        return stmts

    def _gen_hmask(self) -> ir.HorizontalMask:
        def hiv():
            r = self.rng.random()
            if r < 0.3:
                return ir.HorizontalInterval()  # unbounded
            mk = self.rng.choice([ir.AxisBound.start, ir.AxisBound.end])
            o = self.rng.randint(-1, 2)
            lo = mk(o) if mk is ir.AxisBound.start else mk(o - 3)
            hi_mk = self.rng.choice([ir.AxisBound.start, ir.AxisBound.end])
            hi = (
                hi_mk(self.rng.randint(2, 5))
                if hi_mk is ir.AxisBound.start
                else hi_mk(self.rng.randint(-1, 1))
            )
            if r < 0.55:
                return ir.HorizontalInterval(start=lo)
            if r < 0.8:
                return ir.HorizontalInterval(end=hi)
            return ir.HorizontalInterval(start=lo, end=hi)

        return ir.HorizontalMask(i=hiv(), j=hiv())

    def _gen_assign(
        self, order, written_here: List[str], conditional: bool = False
    ) -> ir.Assign:
        r = self.rng.random()
        if conditional:
            # must stay definitively-assigned: outputs or existing temps
            pool = self.outputs + self.temps_assigned
            target = self.rng.choice(pool)
        elif r < 0.4:
            target = self.rng.choice(self.outputs)
        elif r < 0.7 and self.temps_assigned:
            target = self.rng.choice(self.temps_assigned)
        else:
            target = f"tmp{self.n_temps}"
            self.n_temps += 1
        value = self._gen_expr(order, written_here, depth=0)
        if target not in self.temps_assigned and target not in self.outputs:
            # definitively assigned only from this statement on
            self.temps_assigned.append(target)
        # self-reads must be offset-free horizontally (race rule,
        # gtir.py:96-110): neutralize any generated offsets on the target
        for acc in ir.field_accesses(value):
            if acc.name == target and isinstance(acc.offset, ir.CartesianOffset):
                if acc.offset.i or acc.offset.j:
                    acc.offset = ir.CartesianOffset(0, 0, acc.offset.k)
        if not conditional and target not in written_here:
            written_here.append(target)
        return ir.Assign(target=ir.FieldAccess(name=target), value=value)

    def _gen_expr(self, order, written_here: List[str], depth: int) -> ir.Expr:
        serial = order != ir.LoopOrder.PARALLEL
        r = self.rng.random()
        if depth >= 3 or r < 0.35:
            return self._gen_leaf(order, written_here)
        if r < 0.8:
            op = self.rng.choice(
                [
                    ir.BinaryOperator.ADD,
                    ir.BinaryOperator.SUB,
                    ir.BinaryOperator.MUL,
                ]
            )
            return ir.BinaryOp(
                op=op,
                left=self._gen_expr(order, written_here, depth + 1),
                right=self._gen_expr(order, written_here, depth + 1),
            )
        if r < 0.9:
            fn = self.rng.choice(
                [ir.NativeFunction.ABS, ir.NativeFunction.SIN, ir.NativeFunction.TANH]
            )
            return ir.NativeFuncCall(
                func=fn, args=[self._gen_expr(order, written_here, depth + 1)]
            )
        return ir.TernaryOp(
            cond=ir.BinaryOp(
                op=ir.BinaryOperator.LT,
                left=self._gen_leaf(order, written_here),
                right=ir.Literal(value=0.5),
            ),
            true_expr=self._gen_expr(order, written_here, depth + 1),
            false_expr=self._gen_expr(order, written_here, depth + 1),
        )

    def _gen_leaf(self, order, written_here: List[str]) -> ir.Expr:
        serial = order != ir.LoopOrder.PARALLEL
        r = self.rng.random()
        if r < 0.12:
            return ir.Literal(value=round(self.rng.uniform(-2, 2), 3))
        if r < 0.2:
            return ir.ScalarAccess(name=self.rng.choice(self.scalars))
        candidates = list(self.inputs)
        # any definitively-assigned temp is readable: same-section at zero
        # offset (plus behind-the-sweep K in serial loops), earlier-section
        # ones also at horizontal offsets (extent analysis extends them)
        name = self.rng.choice(candidates + self.temps_assigned)
        if name in self.inputs:
            rr = self.rng.random()
            if rr < 0.08:
                # data-dependent K offset (clipped to field bounds)
                return ir.FieldAccess(
                    name=name,
                    offset=ir.VariableKOffset(
                        k=ir.Literal(
                            value=self.rng.randint(-3, 3),
                            dtype=np.dtype(np.int64),
                        )
                    ),
                )
            if rr < 0.16:
                # absolute K read
                return ir.FieldAccess(
                    name=name,
                    offset=ir.AbsoluteKIndex(
                        k=ir.Literal(
                            value=self.rng.randint(0, 4),
                            dtype=np.dtype(np.int64),
                        )
                    ),
                )
            di = self.rng.randint(-MAX_OFFSET, MAX_OFFSET)
            dj = self.rng.randint(-MAX_OFFSET, MAX_OFFSET)
            dk = self.rng.randint(-1, 1)
            return ir.FieldAccess(name=name, offset=ir.CartesianOffset(di, dj, dk))
        if name in written_here and serial and self.rng.random() < 0.4:
            behind = -1 if order == ir.LoopOrder.FORWARD else 1
            return ir.FieldAccess(
                name=name, offset=ir.CartesianOffset(0, 0, behind)
            )
        if name not in written_here and self.rng.random() < 0.5:
            # temp from an earlier section: horizontal offsets are legal
            di = self.rng.randint(-1, 1)
            dj = self.rng.randint(-1, 1)
            return ir.FieldAccess(name=name, offset=ir.CartesianOffset(di, dj, 0))
        return ir.FieldAccess(name=name)


def run_differential_case(
    seed: int,
    domain=None,
    halo=6,
    backends=("jax",),
    dtype=np.float64,
    aligned=False,
    rtol=1e-12,
    atol=1e-12,
    periodic=(),
    canonical_f16=False,
    allow_while: bool = True,
    max_flip_fraction: float = 0.0,
    serialize: bool = False,
) -> None:
    """Generate one program, run the numpy oracle vs each backend in
    ``backends`` ("jax", "pallas"), assert allclose.  On CPU the pallas
    leg runs the interpret-mode kernel path.

    ``aligned=True`` picks a wide geometry (J = 128 with 128-point J halos,
    I a multiple of 8 or 16), so the column kernel runs several blocks
    per row.  ``serialize=True`` runs the backends on the program's
    ``passes.serialize_parallel_k`` form (where it applies)."""
    from gt4py_tpu.cartesian import analysis as analysis_mod
    from gt4py_tpu.cartesian.backend import from_name

    rng = random.Random(seed)
    sub = 16 if np.dtype(dtype).itemsize == 2 else 8
    if domain is None:
        if aligned:
            # I on the sublane grid, J on the lane (128) grid
            domain = (sub * rng.randint(1, 3), 128, rng.randint(1, 7))
        else:
            # vary the domain shape per seed: exercises extent clipping,
            # single-plane K, and non-square IJ paths
            domain = (rng.randint(3, 9), rng.randint(3, 9), rng.randint(1, 7))
    gen = ProgramGenerator(rng, dtype=dtype, allow_while=allow_while)
    stencil = gen.generate()
    if canonical_f16:
        # the product build path's f16-storage canonicalization (16-bit
        # dtypes store, f32 computes) -- exercises the kernel's per-tile
        # unpack; the raw form (default) exercises per-op semantics
        from gt4py_tpu.cartesian import passes as passes_mod

        stencil = passes_mod.widen_f16_compute(stencil)
    an = analysis_mod.analyze(stencil)
    an_run = an
    if serialize:
        from gt4py_tpu.cartesian import passes as passes_mod

        ser = passes_mod.serialize_parallel_k(stencil)
        if ser is not None:
            an_run = analysis_mod.analyze(ser)

    nprng = np.random.default_rng(seed)
    if aligned:
        shape = (sub + domain[0] + sub, 128 + domain[1] + 128, domain[2] + 2)
        origin = (sub, 128, 1)
    else:
        shape = (domain[0] + 2 * halo, domain[1] + 2 * halo, domain[2] + 2)
        origin = (halo, halo, 1)
    arrays = {}
    origins = {}
    for name in gen.inputs + gen.outputs:
        arrays[name] = nprng.random(shape).astype(dtype)
        origins[name] = origin

    scalars = {"s0": nprng.uniform(-1, 1), "s1": nprng.uniform(-1, 1)}

    ref = {k: v.copy() for k, v in arrays.items()}
    try:
        from_name("numpy")(an).run(ref, scalars, domain, origins, periodic=periodic)
    except ValueError:
        # read halo wider than the periodic domain: the oracle rejects;
        # every backend must reject identically (no silent multi-wrap)
        for backend in backends:
            jx = {k: v.copy() for k, v in arrays.items()}
            try:
                from_name(backend)(an, {}).run(
                    jx, scalars, domain, origins, periodic=periodic
                )
            except ValueError:
                continue
            raise AssertionError(
                f"seed {seed}: oracle rejects periodic domain but "
                f"'{backend}' accepted it\n" + _dump(stencil)
            )
        return

    for backend in backends:
        jx = {k: v.copy() for k, v in arrays.items()}
        result = from_name(backend)(an_run, {}).run(
            jx, scalars, domain, origins, periodic=periodic
        )
        for name, new in result.items():
            jx[name][...] = np.asarray(new)

        # periodic fill mutates read-only inputs in place on the numpy
        # oracle, but functional backends cannot return unwritten fields:
        # compare written fields only (their halos DO carry fill parity)
        names = gen.outputs if periodic else gen.outputs + gen.inputs
        flips_ok = max_flip_fraction > 0 and _has_data_branches(stencil)
        for name in names:
            if flips_ok:
                # ON-CARD comparison contract: the GPU compilers contract
                # multiply-adds into FMAs, so a data-dependent branch
                # condition within one ulp of its threshold can FLIP vs
                # the oracle -- an isolated point then takes a different
                # branch (or while-iteration count) and no tolerance
                # covers the delta.  Allow a TINY fraction of such points
                # (far below any systematic-bug signature: the r5
                # region-anchor bug diverged at 2.1e-2, 200x the cap)
                # for programs that actually contain data-dependent
                # branches; everything else stays exact-tolerance.
                a, b = jx[name], ref[name]
                with np.errstate(invalid="ignore"):
                    bad = ~np.isclose(a, b, rtol=rtol, atol=atol, equal_nan=True)
                frac = bad.sum() / bad.size
                if 0 < frac <= max_flip_fraction:
                    continue
            np.testing.assert_allclose(
                jx[name],
                ref[name],
                rtol=rtol,
                atol=atol,
                err_msg=f"seed {seed}: field '{name}' diverges ({backend})\n"
                + _dump(stencil),
            )


def _has_data_branches(stencil) -> bool:
    """Does any If/While/ternary condition read a field or temp?  Only
    such programs can exhibit on-chip branch flips (scalar/literal
    conditions evaluate identically everywhere)."""

    def cond_reads_field(cond) -> bool:
        if isinstance(cond, ir.FieldAccess):
            return True
        return any(
            cond_reads_field(c)
            for c in ir.children(cond)
            if not isinstance(c, (str, int, float, bool, type(None)))
        )

    for node in ir.walk_values(stencil.vertical_loops):
        if isinstance(node, (ir.If, ir.While, ir.TernaryOp)):
            if cond_reads_field(node.cond):
                return True
    return False


def _dump(stencil) -> str:
    from gt4py_tpu.cartesian.pretty import pformat_stencil

    return pformat_stencil(stencil)

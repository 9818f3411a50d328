"""The single validated stencil IR ("SIR").

A collapse of the reference's DefIR -> GTIR -> OIR chain
(reference: src/gt4py/cartesian/gtc/gtir.py, src/gt4py/cartesian/gtc/oir.py,
src/gt4py/cartesian/gtc/common.py) into one IR that carries GTScript
parallel-model semantics directly:

- A ``Stencil`` is a list of ``VerticalLoop``s executed in order.
- A ``VerticalLoop`` has a ``LoopOrder`` and a list of ``VerticalSection``s,
  each restricted to a K ``Interval``.
- In a PARALLEL loop each top-level statement is a whole-domain parallel
  assignment: statement N+1 observes statement N's writes at every point
  (reference: gtir.py:78-110).  In FORWARD/BACKWARD loops the K levels
  execute sequentially, enabling scans and tridiagonal solves.
- Temporaries are stencil-wide 3D fields (the reference's OIR demotes some
  to scalars purely as an optimization; numerics are identical).

Validation of the parallel-model race rules lives in ``validation.py``.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np


# --------------------------------------------------------------------------- #
# Enums and small value types
# --------------------------------------------------------------------------- #


class LoopOrder(enum.Enum):
    PARALLEL = 0
    FORWARD = 1
    BACKWARD = -1


class LevelMarker(enum.Enum):
    START = "start"
    END = "end"


@dataclass(frozen=True)
class AxisBound:
    """A position on an axis: offset relative to domain START or END.

    Mirrors reference semantics (gtc/common.py:754-800): intervals are
    half-open ``[start, end)``; negative user literals map to END-relative.
    """

    level: LevelMarker
    offset: int = 0

    @classmethod
    def start(cls, offset: int = 0) -> "AxisBound":
        return cls(LevelMarker.START, offset)

    @classmethod
    def end(cls, offset: int = 0) -> "AxisBound":
        return cls(LevelMarker.END, offset)

    @classmethod
    def from_value(cls, value: Optional[int], *, is_end: bool) -> "AxisBound":
        """Convert a user-facing interval bound to an AxisBound.

        ``None`` means START (lower bound) or END (upper bound);
        non-negative ints are START-relative; negative ints END-relative.
        """
        if value is None:
            return cls.end() if is_end else cls.start()
        if not isinstance(value, (int, np.integer)):
            raise TypeError(f"Invalid interval bound: {value!r}")
        value = int(value)
        if value >= 0:
            return cls.start(value)
        return cls.end(value)

    def resolve(self, size: int) -> int:
        """Concrete index given the domain size along the axis."""
        base = 0 if self.level == LevelMarker.START else size
        return base + self.offset


@dataclass(frozen=True)
class RuntimeAxisBound:
    """A K bound given by a run-time scalar parameter, START-relative
    (reference: frontend/nodes.py RuntimeAxisBound; resolved at call time,
    so compiled variants are cached per bound value)."""

    name: str
    offset: int = 0

    def resolve(self, size: int, scalars: Optional[Dict[str, Any]] = None) -> int:
        if scalars is None or self.name not in scalars:
            raise ValueError(
                f"Runtime interval bound '{self.name}' needs a scalar value"
            )
        return int(scalars[self.name]) + self.offset


@dataclass(frozen=True)
class Interval:
    """Half-open K interval [start, end)."""

    start: Union[AxisBound, "RuntimeAxisBound"]
    end: Union[AxisBound, "RuntimeAxisBound"]

    @classmethod
    def full(cls) -> "Interval":
        return cls(AxisBound.start(), AxisBound.end())

    @property
    def is_runtime(self) -> bool:
        return isinstance(self.start, RuntimeAxisBound) or isinstance(
            self.end, RuntimeAxisBound
        )

    def resolve(
        self, size: int, scalars: Optional[Dict[str, Any]] = None
    ) -> Tuple[int, int]:
        def res(b):
            if isinstance(b, RuntimeAxisBound):
                return b.resolve(size, scalars)
            return b.resolve(size)

        return (res(self.start), res(self.end))

    def is_single_level_static(self) -> bool:
        if self.is_runtime:
            return False
        return (
            self.start.level == self.end.level
            and self.end.offset - self.start.offset == 1
        )


@dataclass(frozen=True)
class HorizontalInterval:
    """Half-open interval on I or J for `horizontal(region[...])` masks.

    ``start``/``end`` of None mean unbounded on that side
    (reference: gtc/common.py:802-868).
    """

    start: Optional[AxisBound] = None
    end: Optional[AxisBound] = None

    def resolve(self, size: int) -> Tuple[int, int]:
        lo = self.start.resolve(size) if self.start is not None else -(1 << 30)
        hi = self.end.resolve(size) if self.end is not None else (1 << 30)
        return lo, hi


@dataclass(frozen=True)
class HorizontalMask:
    i: HorizontalInterval = HorizontalInterval()
    j: HorizontalInterval = HorizontalInterval()


# --------------------------------------------------------------------------- #
# Offsets
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class CartesianOffset:
    i: int = 0
    j: int = 0
    k: int = 0

    @classmethod
    def zero(cls) -> "CartesianOffset":
        return cls()


@dataclass
class VariableKOffset:
    """Data-dependent K offset: ``field[0, 0, expr]`` (gtc/common.py:341-352).

    Reads clip the resulting K index to the field bounds, matching the
    reference numpy runtime (cartesian/utils/field.py:56-66).
    """

    k: "Expr"


@dataclass
class AbsoluteKIndex:
    """Absolute K read: ``field.at(K=expr)`` (gtc/common.py:354-380)."""

    k: "Expr"


Offset = Union[CartesianOffset, VariableKOffset, AbsoluteKIndex]


# --------------------------------------------------------------------------- #
# Expressions
# --------------------------------------------------------------------------- #


class NativeFunction(enum.Enum):
    """Math builtins (reference: gtc/common.py:150-248, 34 functions)."""

    ABS = "abs"
    MIN = "min"
    MAX = "max"
    MOD = "mod"
    SIN = "sin"
    COS = "cos"
    TAN = "tan"
    ARCSIN = "asin"
    ARCCOS = "acos"
    ARCTAN = "atan"
    ARCTAN2 = "atan2"
    SINH = "sinh"
    COSH = "cosh"
    TANH = "tanh"
    ARCSINH = "asinh"
    ARCCOSH = "acosh"
    ARCTANH = "atanh"
    SQRT = "sqrt"
    EXP = "exp"
    LOG = "log"
    LOG10 = "log10"
    LOG2 = "log2"
    GAMMA = "gamma"
    CBRT = "cbrt"
    ISFINITE = "isfinite"
    ISINF = "isinf"
    ISNAN = "isnan"
    FLOOR = "floor"
    CEIL = "ceil"
    TRUNC = "trunc"
    ROUND = "round"
    ROUND_AWAY_FROM_ZERO = "round_away_from_zero"
    ERF = "erf"
    ERFC = "erfc"
    POW = "pow"

    @property
    def arity(self) -> int:
        return {
            NativeFunction.MIN: 2,
            NativeFunction.MAX: 2,
            NativeFunction.MOD: 2,
            NativeFunction.ARCTAN2: 2,
            NativeFunction.POW: 2,
        }.get(self, 1)


@dataclass
class Expr:
    pass


@dataclass
class Literal(Expr):
    value: Any
    dtype: Optional[np.dtype] = None  # resolved during dtype inference


@dataclass
class ScalarAccess(Expr):
    """Read of a run-time scalar parameter."""

    name: str


@dataclass
class FieldAccess(Expr):
    name: str
    offset: Offset = field(default_factory=CartesianOffset.zero)
    data_index: Tuple["Expr", ...] = ()


@dataclass
class AxisPosition(Expr):
    """Global index along an axis within the compute domain (I/J/K builtins).

    Reference: gtir.IteratorAccess (gtir.py:66-76).
    """

    axis: str  # "I" | "J" | "K"


@dataclass
class AxisSize(Expr):
    """Domain size along an axis (``splitters``-style; used for bounds)."""

    axis: str


class UnaryOperator(enum.Enum):
    POS = "+"
    NEG = "-"
    NOT = "not"


class BinaryOperator(enum.Enum):
    ADD = "+"
    SUB = "-"
    MUL = "*"
    DIV = "/"
    FLOOR_DIV = "//"
    MOD = "%"
    POW = "**"
    AND = "and"
    OR = "or"
    EQ = "=="
    NE = "!="
    LT = "<"
    LE = "<="
    GT = ">"
    GE = ">="
    BIT_AND = "&"
    BIT_OR = "|"
    BIT_XOR = "^"

    @property
    def is_comparison(self) -> bool:
        return self in (
            BinaryOperator.EQ,
            BinaryOperator.NE,
            BinaryOperator.LT,
            BinaryOperator.LE,
            BinaryOperator.GT,
            BinaryOperator.GE,
        )

    @property
    def is_logical(self) -> bool:
        return self in (BinaryOperator.AND, BinaryOperator.OR)


@dataclass
class UnaryOp(Expr):
    op: UnaryOperator
    expr: Expr


@dataclass
class BinaryOp(Expr):
    op: BinaryOperator
    left: Expr
    right: Expr


@dataclass
class TernaryOp(Expr):
    cond: Expr
    true_expr: Expr
    false_expr: Expr


@dataclass
class NativeFuncCall(Expr):
    func: NativeFunction
    args: List[Expr]


@dataclass
class Cast(Expr):
    dtype: np.dtype
    expr: Expr


# --------------------------------------------------------------------------- #
# Statements
# --------------------------------------------------------------------------- #


@dataclass
class Stmt:
    pass


@dataclass
class Assign(Stmt):
    """Parallel assignment (reference: gtir.ParAssignStmt, gtir.py:78-110)."""

    target: FieldAccess
    value: Expr


@dataclass
class If(Stmt):
    """Pointwise conditional.

    Field-valued conditions execute both branches under complementary masks
    (reference: gtir.FieldIfStmt); scalar conditions have identical
    pointwise semantics and are treated uniformly.
    """

    cond: Expr
    body: List[Stmt]
    orelse: List[Stmt]


@dataclass
class While(Stmt):
    """Pointwise while loop (reference: gtir.While, gtir.py:156-165)."""

    cond: Expr
    body: List[Stmt]


@dataclass
class HorizontalRestriction(Stmt):
    """Restrict body to the union of horizontal regions
    (reference: gtc/common.py:870-900 HorizontalMask/HorizontalRestriction).
    """

    masks: List[HorizontalMask]
    body: List[Stmt]


# --------------------------------------------------------------------------- #
# Declarations & stencil
# --------------------------------------------------------------------------- #


@dataclass
class FieldDecl:
    name: str
    dtype: np.dtype
    dimensions: Tuple[bool, bool, bool] = (True, True, True)  # I, J, K presence
    data_dims: Tuple[int, ...] = ()
    is_api: bool = True


@dataclass
class ScalarDecl:
    name: str
    dtype: Optional[np.dtype]  # None: inferred from the call argument


@dataclass
class ApiParam:
    """Call-signature entry (field or scalar), in declaration order."""

    name: str
    is_field: bool
    is_keyword: bool = False
    optional: bool = False  # ``= None`` default pruned by externals


@dataclass
class VerticalSection:
    interval: Interval
    body: List[Stmt]


@dataclass
class VerticalLoop:
    loop_order: LoopOrder
    sections: List[VerticalSection]


@dataclass
class Stencil:
    name: str
    api_params: List[ApiParam]
    field_decls: Dict[str, FieldDecl]
    scalar_decls: Dict[str, ScalarDecl]
    temp_decls: Dict[str, FieldDecl]
    vertical_loops: List[VerticalLoop]
    externals: Dict[str, Any] = field(default_factory=dict)
    sources: str = ""
    #: dtype of untyped float/int literals (reference: literal-precision
    #: build options, cartesian/definitions.py:30-43); None -> config default
    literal_float_dtype: Optional[np.dtype] = None
    literal_int_dtype: Optional[np.dtype] = None

    def walk_loops(self):
        yield from self.vertical_loops

    def decl(self, name: str) -> Optional[FieldDecl]:
        return self.field_decls.get(name) or self.temp_decls.get(name)


# --------------------------------------------------------------------------- #
# Generic tree walking
# --------------------------------------------------------------------------- #


def children(node: Any):
    """Yield all IR-node children of a dataclass node (minimal eve.trees)."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, (Expr, Stmt, VerticalLoop, VerticalSection)):
                yield v
            elif isinstance(v, (VariableKOffset, AbsoluteKIndex)):
                yield v.k  # data-dependent K offsets carry an expression
            elif isinstance(v, (list, tuple)):
                for item in v:
                    if isinstance(item, (Expr, Stmt, VerticalLoop, VerticalSection)):
                        yield item


def walk(node: Any):
    """Pre-order walk over IR nodes."""
    yield node
    for c in children(node):
        yield from walk(c)


def walk_values(nodes) -> "list":
    out = []
    if isinstance(nodes, (list, tuple)):
        for n in nodes:
            out.extend(walk(n))
    else:
        out.extend(walk(nodes))
    return out


def field_accesses(node: Any) -> List[FieldAccess]:
    return [n for n in walk_values(node) if isinstance(n, FieldAccess)]


def assigned_names(stmts: List[Stmt]) -> List[str]:
    """Names written anywhere within the statements (in order, unique)."""
    seen: List[str] = []
    for n in walk_values(stmts):
        if isinstance(n, Assign) and n.target.name not in seen:
            seen.append(n.target.name)
    return seen

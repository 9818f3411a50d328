"""Call-time machinery: argument binding, origin normalization, domain
inference, validation, dispatch.

Reference: src/gt4py/cartesian/stencil_object.py:146-665 (StencilObject,
_call_run, _normalize_origins, _get_max_domain, _validate_args) and
FrozenStencil :94-143.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from gt4py_tpu.cartesian.analysis import AccessKind, StencilAnalysis


class ArgumentError(ValueError):
    pass


def _array_of(value):
    """Extract the raw array and metadata from a field argument."""
    from gt4py_tpu.storage import FieldStorage

    if isinstance(value, FieldStorage):
        return value.data, value.origin, value
    return value, getattr(value, "__gt_origin__", None), None


def _normalize_periodic(periodic) -> Tuple[str, ...]:
    """``periodic="I"`` / ``("I", "J")`` / ``"IJ"`` -> sorted axis tuple.

    Periodic execution: reads beyond the compute domain wrap around it
    (implemented as read-extent halo fills; the pallas backend subsumes
    them into wrapped-window tile DMA)."""
    if not periodic:
        return ()
    axes = tuple(periodic) if not isinstance(periodic, str) else tuple(periodic)
    out = []
    for ax in axes:
        a = str(ax).upper()
        if a not in ("I", "J"):
            raise ArgumentError(
                f"periodic= accepts axes 'I' and 'J', got {ax!r}"
            )
        out.append(a)
    return tuple(sorted(set(out)))


class StencilObject:
    """A built, callable stencil.

    Calling conventions mirror the reference: positional/keyword field and
    scalar arguments in declaration order, plus ``origin=``, ``domain=``,
    ``exec_info=`` and ``validate_args=`` keywords.
    """

    def __init__(
        self,
        analysis: StencilAnalysis,
        backend,
        backend_name: str,
        name: str,
        options: Dict[str, Any],
        stencil_id: str,
    ):
        self.analysis = analysis
        self.backend = backend
        self.backend_name = backend_name
        self.name = name
        self.options = options
        self.stencil_id = stencil_id
        self.field_info = analysis.field_info
        self.parameter_info = analysis.parameter_info
        self.ir = analysis.stencil
        self._domain_origin_cache: Dict[Any, Any] = {}

    # ------------------------------------------------------------------ #

    def __call__(
        self,
        *args,
        origin=None,
        domain=None,
        exec_info: Optional[dict] = None,
        validate_args: bool = True,
        periodic=(),
        **kwargs,
    ):
        t0 = time.perf_counter()
        if exec_info is not None:
            exec_info["call_run_start_time"] = t0

        from gt4py_tpu.instrumentation import stencil_call_context

        field_args, scalar_args = self._bind_args(args, kwargs)
        with stencil_call_context.activate(name=self.name, backend=self.backend_name):
            self._call_run(
                field_args, scalar_args, origin, domain, exec_info, validate_args,
                periodic=periodic,
            )

        t1 = time.perf_counter()
        if exec_info is not None:
            exec_info["call_run_end_time"] = t1
            # '__aggregate_data' magic key: per-stencil cumulative stats
            # (reference: backend/templates/stencil_module.py.in:125-158)
            if exec_info.get("__aggregate_data", False):
                agg = exec_info.setdefault(self.name, {})
                agg["call_time"] = t1 - t0
                agg["total_call_time"] = agg.get("total_call_time", 0.0) + (t1 - t0)
                agg["ncalls"] = agg.get("ncalls", 0) + 1
                if "run_end_time" in exec_info:
                    rt = exec_info["run_end_time"] - exec_info["run_start_time"]
                    agg["run_time"] = rt
                    agg["total_run_time"] = agg.get("total_run_time", 0.0) + rt

        from gt4py_tpu.instrumentation import MetricLevel, collect_sample

        collect_sample(self.name, "call_time", t1 - t0, MetricLevel.PERFORMANCE)

    def run(self, *, _domain_, _origin_, exec_info=None, **kwargs):
        """Low-level entry: explicit domain and per-field origins."""
        field_args = {}
        scalar_args = {}
        for p in self.ir.api_params:
            if p.name in kwargs:
                (field_args if p.is_field else scalar_args)[p.name] = kwargs[p.name]
        self._call_run(field_args, scalar_args, _origin_, _domain_, exec_info, False)

    # ------------------------------------------------------------------ #

    def _bind_args(self, args, kwargs) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        field_args: Dict[str, Any] = {}
        scalar_args: Dict[str, Any] = {}
        params = self.ir.api_params
        if len(args) > len(params):
            raise ArgumentError(
                f"Too many positional arguments for stencil '{self.name}'"
            )
        for p, a in zip(params, args):
            if p.is_keyword:
                raise ArgumentError(
                    f"Parameter '{p.name}' of stencil '{self.name}' is "
                    "keyword-only"
                )
        pos = {p.name: a for p, a in zip(params, args)}
        for p in params:
            if p.name in pos and p.name in kwargs:
                raise ArgumentError(f"Duplicate argument '{p.name}'")
            if p.name in pos:
                value = pos[p.name]
            elif p.name in kwargs:
                value = kwargs[p.name]
            elif p.optional:
                value = None
            else:
                raise ArgumentError(
                    f"Missing argument '{p.name}' for stencil '{self.name}'"
                )
            (field_args if p.is_field else scalar_args)[p.name] = value
        return field_args, scalar_args

    def _call_run(
        self, field_args, scalar_args, origin, domain, exec_info, validate_args,
        periodic=(),
    ) -> None:
        arrays: Dict[str, np.ndarray] = {}
        holders: Dict[str, Any] = {}
        origins: Dict[str, Tuple[int, ...]] = {}

        origin = self._normalize_origin_arg(origin)
        periodic = _normalize_periodic(periodic)

        for name, value in field_args.items():
            if value is None:
                info = self.field_info.get(name)
                if info is not None and info.access != AccessKind.NONE:
                    raise ArgumentError(f"Field '{name}' is required but got None")
                continue
            arr, attr_origin, holder = _array_of(value)
            if holder is None:
                arr, attr_origin = self._reorder_duck_dims(name, value, arr, attr_origin)
            arrays[name] = arr
            holders[name] = holder
            origins[name] = self._field_origin(name, origin, attr_origin)

        domain = self._get_max_domain(arrays, origins) if domain is None else tuple(domain)

        if validate_args:
            self._validate_args(arrays, scalar_args, origins, domain)

        result = self.backend.run(
            arrays, scalar_args, domain, origins, exec_info, periodic=periodic
        )

        # functional backends (jax) return updated arrays: write them back
        if result is not None:
            for name, new_arr in result.items():
                holder = holders.get(name)
                if holder is not None:
                    holder.data = new_arr
                else:
                    target = arrays[name]
                    if isinstance(target, np.ndarray):
                        target[...] = np.asarray(new_arr)
                    else:
                        raise ArgumentError(
                            f"Backend '{self.backend_name}' returned a new array "
                            f"for '{name}' but the input holder is immutable; "
                            "pass gt4py_tpu.storage fields instead."
                        )

    # ------------------------------------------------------------------ #

    def _reorder_duck_dims(self, name, value, arr, attr_origin):
        """Duck arrays carrying ``__gt_dims__`` in a different axis order
        get transposed (a view) to the stencil's declared order, and
        their ``__gt_origin__`` is permuted along (reference: the
        `__gt_dims__` storage protocol, backend/dace_stencil_object.py:33)."""
        gt_dims = getattr(value, "__gt_dims__", None)
        if gt_dims is None:
            return arr, attr_origin
        decl = self.ir.field_decls.get(name)
        if decl is None:
            return arr, attr_origin
        expected = [ax for ax, m in zip("IJK", decl.dimensions) if m]
        got = [str(d).upper() for d in gt_dims[: len(expected)]]
        if got == expected:
            return arr, attr_origin
        if sorted(got) != sorted(expected):
            raise ArgumentError(
                f"Field '{name}': __gt_dims__ {tuple(gt_dims)} does not "
                f"match the declared axes {tuple(expected)}"
            )
        perm = [got.index(ax) for ax in expected]
        perm += list(range(len(expected), np.ndim(arr)))  # data axes stay
        arr = np.transpose(arr, perm) if isinstance(arr, np.ndarray) else arr.transpose(perm)
        if attr_origin is not None:
            spatial = [attr_origin[p] for p in perm[: len(expected)]]
            attr_origin = tuple(spatial) + tuple(attr_origin[len(expected):])
        return arr, attr_origin

    def _normalize_origin_arg(self, origin) -> Dict[str, Tuple[int, ...]]:
        """Reference: stencil_object._normalize_origins (:499-532)."""
        if origin is None:
            return {}
        if isinstance(origin, dict):
            return dict(origin)
        return {"_all_": tuple(int(x) for x in origin)}

    def _field_origin(self, name, origin_map, attr_origin) -> Tuple[int, ...]:
        info = self.field_info[name]
        ndim = info.domain_ndim
        if name in origin_map:
            o = tuple(origin_map[name])
        elif "_all_" in origin_map:
            o = tuple(origin_map["_all_"])
        elif attr_origin is not None:
            o = tuple(attr_origin)
        else:
            o = (0,) * ndim
        if len(o) != ndim:
            # a 3-component (IJK) origin for a lower-dimensional field:
            # select the components of the axes the field actually has
            full = tuple(o) + (0,) * (3 - len(o))
            o = tuple(c for c, present in zip(full, info.dimensions) if present)
        return tuple(int(x) for x in o)

    def _get_max_domain(self, arrays, origins) -> Tuple[int, int, int]:
        """Largest domain compatible with all field shapes
        (reference: stencil_object._get_max_domain, :298-343)."""
        max_domain = [1 << 30] * 3
        for name, arr in arrays.items():
            info = self.field_info[name]
            origin = origins[name]
            spatial_shape = arr.shape[: info.domain_ndim]
            ax_i = 0
            for ax3, present in enumerate(info.dimensions):
                if not present:
                    continue
                upper = (info.boundary.i, info.boundary.j, info.boundary.k)[ax3][1]
                avail = spatial_shape[ax_i] - origin[ax_i] - upper
                max_domain[ax3] = min(max_domain[ax3], avail)
                ax_i += 1
        if any(d >= (1 << 30) or d <= 0 for d in max_domain):
            for i, d in enumerate(max_domain):
                if d >= (1 << 30):
                    max_domain[i] = 1
            if any(d <= 0 for d in max_domain):
                raise ArgumentError(
                    f"Cannot infer a valid domain (got {tuple(max_domain)}); "
                    "check field shapes, origins and halo requirements."
                )
        return tuple(max_domain)

    def _validate_args(self, arrays, scalars, origins, domain) -> None:
        """Reference: stencil_object._validate_args (:345-497)."""
        if len(domain) != 3 or any(int(d) <= 0 for d in domain):
            raise ArgumentError(f"Invalid domain {domain}")
        if domain[2] < self.analysis.min_k_size:
            raise ArgumentError(
                f"Domain K size {domain[2]} is below the stencil minimum "
                f"{self.analysis.min_k_size}"
            )
        for name, arr in arrays.items():
            info = self.field_info[name]
            expected_ndim = info.domain_ndim + len(info.data_dims)
            if arr.ndim != expected_ndim:
                raise ArgumentError(
                    f"Field '{name}' has ndim {arr.ndim}, expected {expected_ndim}"
                )
            if np.dtype(arr.dtype) != np.dtype(info.dtype):
                raise ArgumentError(
                    f"Field '{name}' has dtype {arr.dtype}, expected {info.dtype}"
                )
            if info.data_dims and tuple(arr.shape[info.domain_ndim:]) != tuple(
                info.data_dims
            ):
                raise ArgumentError(
                    f"Field '{name}' data dimensions {arr.shape[info.domain_ndim:]} "
                    f"!= declared {info.data_dims}"
                )
            origin = origins[name]
            ax_i = 0
            for ax3, present in enumerate(info.dimensions):
                if not present:
                    continue
                lower, upper = (info.boundary.i, info.boundary.j, info.boundary.k)[ax3]
                if origin[ax_i] < lower:
                    raise ArgumentError(
                        f"Origin {origin} of field '{name}' is below the halo "
                        f"requirement {lower} on axis {'IJK'[ax3]}"
                    )
                need = origin[ax_i] + domain[ax3] + upper
                if arr.shape[ax_i] < need:
                    raise ArgumentError(
                        f"Field '{name}' axis {'IJK'[ax3]} has size "
                        f"{arr.shape[ax_i]}, needs >= {need} "
                        f"(origin {origin[ax_i]} + domain {domain[ax3]} + halo {upper})"
                    )
                ax_i += 1
        for name, pinfo in self.parameter_info.items():
            if scalars.get(name) is None and pinfo.access != AccessKind.NONE:
                raise ArgumentError(f"Missing scalar parameter '{name}'")

    # ------------------------------------------------------------------ #

    def freeze(self, *, origin, domain) -> "FrozenStencil":
        return FrozenStencil(self, origin, domain)

    def functional(self, *, origin, domain, physical_layout: bool = False,
                   periodic=()):
        """Return a pure function for composing under ``jax.jit``.

        ``fn(**arrays_and_scalars) -> dict`` applies the stencil and returns
        updated arrays for written fields.  Only available on functional
        (jax/pallas) backends.  This is the composition path:
        chains of stencils trace into ONE fused XLA program with no
        host round-trips between them.

        ``periodic=("I", "J")``: reads beyond the domain wrap periodically
        -- chained periodic-boundary stencils then need no explicit halo
        fill passes between stages (the pallas backend folds the wrap into
        the tile DMA at zero extra traffic).
        """
        if not hasattr(self.backend, "apply"):
            raise TypeError(
                f"Backend '{self.backend_name}' does not support functional "
                "composition; use the 'jax' or 'pallas' backend."
            )
        origin_map = self._normalize_origin_arg(origin)
        domain = tuple(domain)
        periodic = _normalize_periodic(periodic)

        def fn(**kwargs):
            arrays = {}
            scalars = {}
            origins = {}
            for p in self.ir.api_params:
                if p.name not in kwargs or kwargs[p.name] is None:
                    continue
                if p.is_field:
                    arrays[p.name] = kwargs[p.name]
                    origins[p.name] = self._field_origin(p.name, origin_map, None)
                else:
                    scalars[p.name] = kwargs[p.name]
            return self.backend.apply(
                arrays, scalars, domain, origins, physical_layout=physical_layout,
                periodic=periodic,
            )

        return fn

    def lowered(self, *, domain=(8, 8, 4), format="jaxpr", origin=None):  # noqa: A002
        """The compiled program's text WITHOUT executing (reference: the
        program-formatters registry, program_processors/program_formatter.py
        -- "dump backend source without running").

        ``format``: ``"ir"`` (GTScript-like stencil IR, any backend),
        ``"jaxpr"`` (the traced program), or ``"hlo"`` (StableHLO as XLA
        receives it).  Shapes come from ``domain`` plus each field's halo
        boundary; dtypes/data-dims from the signature.
        """
        if format == "ir":
            return self.pretty_ir()
        if not hasattr(self.backend, "apply"):
            raise TypeError(
                f"Backend '{self.backend_name}' has no lowered form; "
                "use format='ir' or the 'jax'/'pallas' backend."
            )
        if format not in ("jaxpr", "hlo"):
            raise ValueError(f"unknown format '{format}' (ir | jaxpr | hlo)")
        import jax

        domain = tuple(domain)
        if origin is None:
            origin = {
                name: info.boundary.lower_indices
                for name, info in self.field_info.items()
            }
        origin_map = self._normalize_origin_arg(origin)
        # abstract ShapeDtypeStruct args: inspection never allocates device
        # buffers (important behind a flaky remote backend) and traces once
        args = {}
        for name, info in self.field_info.items():
            og = self._field_origin(name, origin_map, None)
            uppers = info.boundary.upper_indices
            shape = []
            for ax, present in enumerate(info.dimensions):
                if not present:
                    continue
                lo = og[len(shape)]
                shape.append(lo + domain[ax] + uppers[ax])
            shape += list(info.data_dims)
            args[name] = jax.ShapeDtypeStruct(tuple(shape), info.dtype)
        for name, pinfo in self.parameter_info.items():
            args[name] = jax.ShapeDtypeStruct((), pinfo.dtype)
        fn = self.functional(origin=origin, domain=domain)
        if format == "jaxpr":
            return str(jax.make_jaxpr(lambda kw: fn(**kw))(args))
        return jax.jit(lambda kw: fn(**kw)).lower(args).as_text()

    def pretty_ir(self) -> str:
        """The lowered stencil IR as GTScript-like text (inspection parity
        with the reference's ``Program.gtir`` property)."""
        from gt4py_tpu.cartesian.pretty import pformat_stencil

        return pformat_stencil(self.ir)

    def __str__(self) -> str:
        lines = [f"StencilObject '{self.name}' (backend={self.backend_name})"]
        for name, info in self.field_info.items():
            lines.append(
                f"  field {name}: dtype={info.dtype}, access={info.access}, "
                f"boundary={tuple(info.boundary)}"
            )
        for name, pinfo in self.parameter_info.items():
            lines.append(f"  param {name}: dtype={pinfo.dtype}")
        return "\n".join(lines)


class FrozenStencil:
    """Stencil with pre-validated origin/domain for low-overhead calls
    (reference: stencil_object.FrozenStencil, :94-143)."""

    def __init__(self, stencil_object: StencilObject, origin, domain):
        self.stencil_object = stencil_object
        self.origin = origin
        self.domain = tuple(domain)

    def __call__(self, **kwargs):
        field_args = {}
        scalar_args = {}
        for p in self.stencil_object.ir.api_params:
            if p.name in kwargs:
                (field_args if p.is_field else scalar_args)[p.name] = kwargs[p.name]
        self.stencil_object._call_run(
            field_args, scalar_args, self.origin, self.domain, None, False
        )

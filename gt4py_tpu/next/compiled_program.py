"""Ahead-of-time compiled program variants over static arguments.

Reference behavior being reproduced: next/otf/compiled_program.py:161-680
(``CompiledProgramsPool``: precompile one executable per combination of
static-argument values, asynchronously on a thread pool, dispatch calls to
the matching variant, ``wait_for_compilation``).

Design: each variant is a ``jax.jit(fn, static_argnames=...)``
executable produced with the AOT API (``.lower(...).compile()``), so a
dispatch is a cache lookup plus a device call -- no retracing.  Fields
(pytrees) are supported transparently; variants are keyed by the static
values plus the abstract (shape, dtype) signature of the array arguments.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

#: every live pool, so module-level wait_for_compilation() can drain all
#: in-flight background compiles (reference: otf/compiled_program.py:172)
_ALL_POOLS: "weakref.WeakSet" = weakref.WeakSet()


def wait_for_compilation() -> None:
    """Block until every pool's in-flight variants finished compiling
    (useful before timing a first call)."""
    for pool in list(_ALL_POOLS):
        pool.wait_for_compilation()


def _abstract_key(args, kwargs):
    import jax

    leaves, treedef = jax.tree_util.tree_flatten((args, kwargs))
    sig = tuple(
        (getattr(x, "shape", ()), str(getattr(x, "dtype", type(x).__name__)))
        for x in leaves
    )
    return (treedef, sig)


class CompiledProgramsPool:
    """Pool of AOT-compiled variants of one program.

    Parameters
    ----------
    fn:
        The program: any jax-traceable callable (a ``field_operator``'s
        definition, a stencil ``functional``, a plain function).
    static_params:
        Names of keyword parameters treated as compile-time constants; one
        compiled executable exists per distinct combination.
    max_workers:
        Thread-pool width for background compilation.
    """

    def __init__(
        self,
        fn: Callable,
        *,
        static_params: Sequence[str] = (),
        max_workers: int = 2,
    ):
        self.fn = fn
        self.static_params = tuple(static_params)
        self._programs: Dict[Any, Any] = {}
        self._futures: Dict[Any, Future] = {}
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        _ALL_POOLS.add(self)

    # ------------------------------------------------------------------ #

    def _static_key(self, kwargs) -> Tuple:
        return tuple(kwargs[name] for name in self.static_params)

    def _jitted(self):
        import jax

        return jax.jit(self.fn, static_argnames=self.static_params)

    def _compile_one(self, args, dyn_kwargs, static_kwargs):
        compiled = self._jitted().lower(*args, **dyn_kwargs, **static_kwargs).compile()
        from gt4py_tpu.instrumentation import compile_variant_hook

        compile_variant_hook.fire(
            name=getattr(self.fn, "__name__", "<fn>"),
            static_key=self._static_key(static_kwargs),
        )
        return compiled

    def compile(
        self,
        example_args: Tuple = (),
        *,
        wait: bool = False,
        **static_values: Iterable,
    ) -> "CompiledProgramsPool":
        """Precompile one variant per combination of ``static_values``.

        ``compile(example_args=(x, y), n=[1, 2], mode=["a"])`` compiles the
        4... -- 2x1 -- variants ``(n=1, mode='a'), (n=2, mode='a')`` in the
        background against ``example_args``'s shapes.
        """
        names = list(static_values)
        unknown = set(names) - set(self.static_params)
        if unknown:
            raise ValueError(
                f"not static params: {sorted(unknown)} "
                f"(declared: {list(self.static_params)})"
            )
        for combo in itertools.product(*(static_values[n] for n in names)):
            kw = dict(zip(names, combo))
            key = (self._static_key(kw), _abstract_key(example_args, {}))
            with self._lock:
                if key in self._programs or key in self._futures:
                    continue
                self._futures[key] = self._pool.submit(
                    self._compile_one, example_args, {}, kw
                )
        if wait:
            self.wait_for_compilation()
        return self

    def wait_for_compilation(self) -> None:
        """Block until every in-flight variant finished compiling."""
        while True:
            with self._lock:
                if not self._futures:
                    return
                key, fut = next(iter(self._futures.items()))
            program = fut.result()  # re-raises compile errors
            with self._lock:
                self._programs[key] = program
                self._futures.pop(key, None)

    # ------------------------------------------------------------------ #

    def __call__(self, *args, **kwargs):
        static_kw = {n: kwargs.pop(n) for n in self.static_params if n in kwargs}
        missing = [n for n in self.static_params if n not in static_kw]
        if missing:
            raise TypeError(f"missing static arguments: {missing}")
        import jax

        if any(
            isinstance(x, jax.core.Tracer)
            for x in jax.tree_util.tree_leaves((args, kwargs))
        ):
            # called under an outer trace (a program stepped inside a user
            # jit/fori_loop): an AOT executable cannot accept tracers --
            # inline the jitted form into the outer computation instead
            return self._jitted()(*args, **kwargs, **static_kw)
        key = (self._static_key(static_kw), _abstract_key(args, kwargs))
        with self._lock:
            program = self._programs.get(key)
            fut = self._futures.get(key)
        if program is None and fut is not None:
            program = fut.result()
            with self._lock:
                self._programs[key] = program
                self._futures.pop(key, None)
        if program is None:
            # unseen combination: compile synchronously and cache
            program = self._compile_one(args, kwargs, static_kw)
            with self._lock:
                self._programs[key] = program
        from gt4py_tpu.instrumentation import compiled_program_call_context

        with compiled_program_call_context.activate(
            name=getattr(self.fn, "__name__", "<fn>"), variant=key[0]
        ):
            return program(*args, **kwargs)

    @property
    def compiled_keys(self):
        with self._lock:
            return list(self._programs)

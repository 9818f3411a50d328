"""Import-layering discipline (the reference machine-enforces layer
direction in tach.toml:10-40: eve -> nothing; _core -> eve; storage ->
{_core, eve}; cartesian/next -> {_core, eve, storage}).

Our DAG (a collapse; next -> cartesian is the deliberate bridge
to the shared kernel planner, parallel is a low-level distribution
primitive layer under next):

    core            -> (nothing inside gt4py_tpu)
    <root modules>  -> core            (config, errors, cache_manager)
    storage         -> core, <root>
    instrumentation -> <root>
    io              -> <root>
    parallel        -> core, storage, <root>
    cartesian       -> core, storage, errors, instrumentation, <root>
    next            -> core, storage, errors, instrumentation, cartesian,
                       parallel, <root>
    models          -> cartesian, next, <root>
    utils           -> core, parallel, <root>
    testing         -> anything (test tooling sits on top)

Additionally the dtype VOCABULARY (BFLOAT16, promotion) must come from
core.definitions: no module outside cartesian/ may import dtype rules
from cartesian.analysis (VERDICT r3 weak #6).
"""

import ast
import pathlib

import gt4py_tpu

ROOT = pathlib.Path(gt4py_tpu.__file__).parent

#: package (or "<root>" for top-level modules) -> packages it may import
ALLOWED = {
    "core": set(),
    "<root>": {"core"},
    "storage": {"core", "<root>"},
    "instrumentation": {"<root>"},
    "io": {"core", "<root>"},
    "parallel": {"core", "storage", "<root>"},
    "cartesian": {"core", "storage", "errors", "instrumentation", "<root>"},
    "next": {
        "core",
        "storage",
        "errors",
        "instrumentation",
        "cartesian",
        "parallel",
        "<root>",
    },
    "models": {"core", "cartesian", "next", "<root>"},
    "utils": {"core", "parallel", "<root>"},
    "testing": None,  # unrestricted: test tooling sits on top of everything
}

#: names that constitute the dtype vocabulary; importable only from
#: gt4py_tpu.core.definitions outside cartesian/
DTYPE_VOCAB = {"BFLOAT16", "F16_DTYPES", "promote_dtypes", "is_float_dtype",
               "PROMOTION_RANK", "default_float_dtype", "default_int_dtype"}


def _pkg_of(path: pathlib.Path) -> str:
    rel = path.relative_to(ROOT)
    return "<root>" if len(rel.parts) == 1 else rel.parts[0]


def _gt_imports(tree):
    """Yield (module_path, names) for absolute gt4py_tpu imports."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith("gt4py_tpu"):
                    yield a.name, []
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and node.module.startswith("gt4py_tpu"):
                yield node.module, [a.name for a in node.names]


def test_layer_direction():
    violations = []
    for path in ROOT.rglob("*.py"):
        pkg = _pkg_of(path)
        allowed = ALLOWED.get(pkg)
        if allowed is None and pkg in ALLOWED:  # testing: unrestricted
            continue
        assert allowed is not None, f"unmapped package {pkg!r} ({path})"
        tree = ast.parse(path.read_text())
        for mod, _names in _gt_imports(tree):
            parts = mod.split(".")
            tgt = parts[1] if len(parts) > 1 else "<root>"
            # `import gt4py_tpu` / `from gt4py_tpu import config` -> <root>
            if tgt.endswith(".py") or not (ROOT / tgt).is_dir():
                tgt = "<root>"
            if tgt == pkg:
                continue
            if tgt not in allowed:
                violations.append(f"{path.relative_to(ROOT)}: {pkg} -> {mod}")
    assert not violations, "layer violations:\n" + "\n".join(violations)


def test_dtype_vocabulary_only_from_core():
    """Promotion rules / bf16 / f16 sets come from core.definitions;
    nothing outside cartesian/ may pull them out of cartesian.analysis."""
    violations = []
    for path in ROOT.rglob("*.py"):
        pkg = _pkg_of(path)
        if pkg == "cartesian":
            continue  # analysis re-exports for its own backends
        tree = ast.parse(path.read_text())
        for mod, names in _gt_imports(tree):
            if "cartesian" in mod and (set(names) & DTYPE_VOCAB):
                violations.append(
                    f"{path.relative_to(ROOT)}: {sorted(set(names) & DTYPE_VOCAB)} from {mod}"
                )
    assert not violations, (
        "dtype vocabulary imported from cartesian outside cartesian/:\n"
        + "\n".join(violations)
    )


def test_core_is_self_contained():
    """core/ imports nothing from the rest of the package at all."""
    for path in (ROOT / "core").rglob("*.py"):
        tree = ast.parse(path.read_text())
        bad = [m for m, _ in _gt_imports(tree)]
        assert not bad, f"{path}: core must not import {bad}"


def test_promote_dtypes_unknown_dtype_does_not_silently_win():
    """ADVICE r4: dtypes outside the vocabulary must not default to the
    highest rank.  numpy-lattice dtypes promote via np.promote_types;
    truly incompatible ones raise."""
    import numpy as np
    import pytest

    from gt4py_tpu.core.definitions import promote_dtypes

    # known pairs unchanged
    assert promote_dtypes(np.int32, np.float32) == np.dtype(np.float32)
    # complex is outside the vocabulary -> numpy lattice, not auto-win
    assert promote_dtypes(np.complex64, np.float64) == np.dtype(np.complex128)
    assert promote_dtypes(np.float32, np.complex64) == np.dtype(np.complex64)
    # structured dtype cannot promote with a float -> loud error
    rec = np.dtype([("x", np.int32)])
    with pytest.raises(TypeError):
        promote_dtypes(rec, np.float32)

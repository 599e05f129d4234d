"""The port's imports point down, read from the package's source.

The layers from the bottom: `utils/placement.py` and the strip's plain
versions (`ops/strip.py`) below the kernels, the kernels below the carve
loop (`ops/carve.py`), the routes (`parallel/`) above it, and `models/`
at the top.  So no kernel imports the carve loop, nothing below `models/`
imports it, and the carve loop imports every module it uses when it is
imported, never inside a function (a function-level import is how a
cycle between two layers is papered over).
"""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1] / "dct_carver_tpu_torch"


def _modules(*subpackages):
    for sub in subpackages:
        yield from sorted((PKG / sub).glob("*.py"))


def _imported(path: Path):
    """(absolute module name, node) of every import in `path`, both the
    module of a `from` import and each name it takes (which may be a
    submodule)."""
    tree = ast.parse(path.read_text())
    package = ["dct_carver_tpu_torch",
               *path.relative_to(PKG).parent.parts]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = package[:len(package) - node.level + 1]
                base = ".".join(up + ([base] if base else []))
            yield base, node
            for a in node.names:
                yield f"{base}.{a.name}", node


def _offenders(paths, banned: str):
    return [f"{p.relative_to(PKG)}:{node.lineno} imports {name}"
            for p in paths for name, node in _imported(p)
            if name == banned or name.startswith(banned + ".")]


def _kernels_below_the_loop():
    return _offenders(_modules("kernels"), "dct_carver_tpu_torch.ops.carve")


def _models_on_top():
    return _offenders(_modules("ops", "kernels", "parallel", "utils"),
                      "dct_carver_tpu_torch.models")


def _loop_imports_at_module_level():
    tree = ast.parse((PKG / "ops" / "carve.py").read_text())
    return [f"ops/carve.py:{node.lineno} imports inside {fn.name}"
            for fn in ast.walk(tree)
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            for node in ast.walk(fn)
            if isinstance(node, (ast.Import, ast.ImportFrom))]


RULES = {"kernels-below-the-carve-loop": _kernels_below_the_loop,
         "models-on-top": _models_on_top,
         "carve-loop-imports-at-module-level": _loop_imports_at_module_level}


@pytest.mark.parametrize("rule", list(RULES))
def test_imports_point_down(rule):
    assert RULES[rule]() == []

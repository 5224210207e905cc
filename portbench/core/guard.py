"""The import guard: the JAX package and JAX itself must not be loaded in
the process that measures the port.  Module names are compared by their
top-level name (the part before the first dot) as a whole, since the
port's own name, ``mrla_tpu_torch``, begins with the JAX package's."""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

BANNED = ("jax", "jaxlib", "flax", "mrla_tpu")
# the references may not use the program either
REFERENCE_BANNED = BANNED + ("mrla_tpu_torch",)


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def banned_modules(names: Iterable[str], banned=BANNED) -> List[str]:
    """The names among ``names`` whose top-level name is one of
    ``banned``."""
    return sorted(n for n in names if top_level(n) in banned)


def loaded_banned() -> List[str]:
    """The banned modules this process has loaded."""
    return banned_modules(list(sys.modules))


def imported_names(path: Path) -> List[str]:
    """Every module a Python source imports, absolute names (a relative
    import names its package's)."""
    tree = ast.parse(Path(path).read_text(), str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append(node.module if node.level == 0 else "portbench")
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.append(str(node.args[0].value))
    return out

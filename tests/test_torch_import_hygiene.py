"""The port imports neither JAX nor the JAX package.

tests/conftest.py imports jax into the test process, so the import check
runs in a subprocess: importing every module of stellard_tpu_torch must
leave `jax` and every `stellard_tpu.` module out of sys.modules. An AST
scan of the package's sources checks the same statically.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "stellard_tpu_torch"


def _modules() -> list[str]:
    out = []
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_every_module_imports_without_jax():
    mods = _modules()
    assert len(mods) >= 20
    # the ledger/engine slice is covered by the same walk
    assert {"stellard_tpu_torch.protocol.sttx", "stellard_tpu_torch.state.ledger",
            "stellard_tpu_torch.engine.payment", "stellard_tpu_torch.node.ledgermaster",
            "stellard_tpu_torch.utils.ripemd160"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'stellard_tpu.'))\n"
        "             or m == 'stellard_tpu')\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def _imported_names(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for name in _imported_names(tree):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "stellard_tpu"):
                offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert offenders == []

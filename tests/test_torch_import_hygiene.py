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
    # and so is the order-book slice: every transactor, the path engine, K4
    assert {"stellard_tpu_torch.engine.offers", "stellard_tpu_torch.engine.trust",
            "stellard_tpu_torch.engine.account", "stellard_tpu_torch.engine.change",
            "stellard_tpu_torch.engine.inflation", "stellard_tpu_torch.paths.flow",
            "stellard_tpu_torch.paths.pathfinder", "stellard_tpu_torch.paths.orderbook",
            "stellard_tpu_torch.paths.quality", "stellard_tpu_torch.paths.plane",
            "stellard_tpu_torch.ops.pathq"} <= set(mods)
    # and so is the persistence slice: the node store, its native loader,
    # the eager node cache and the ledger tools
    assert {"stellard_tpu_torch.nodestore", "stellard_tpu_torch.nodestore.core",
            "stellard_tpu_torch.nodestore.backends", "stellard_tpu_torch.nodestore.segstore",
            "stellard_tpu_torch.native", "stellard_tpu_torch.state.hotcache",
            "stellard_tpu_torch.node.ledgertools"} <= set(mods)
    # and so is the default close's slice: delta replay, the close
    # pipeline, the txdb and the CLF
    assert set(CLOSE_SLICE) <= set(mods)
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


# the modules of the default close's slice, and the only modules outside
# the package they may import: the standard library's threading, timing
# and typing helpers, and sqlite3 as their one storage engine
CLOSE_SLICE = ("stellard_tpu_torch.node.metrics", "stellard_tpu_torch.node.txdb",
               "stellard_tpu_torch.state.clf", "stellard_tpu_torch.node.node",
               "stellard_tpu_torch.node.closepipeline", "stellard_tpu_torch.state.specview",
               "stellard_tpu_torch.engine.deltareplay", "stellard_tpu_torch.node.ledgermaster")
CLOSE_SLICE_IMPORTS = {"__future__", "bisect", "contextlib", "dataclasses", "logging",
                       "sqlite3", "threading", "time", "typing"}


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


def test_native_loader_never_writes_under_native(tmp_path):
    """The port builds native/src/nodestore.cc into its own build
    directory and leaves native/ (sources, Makefile, the JAX package's
    libraries) as it found it; loading it imports nothing of JAX."""
    native = REPO / "native"
    before = {p: (p.stat().st_size, p.stat().st_mtime_ns) for p in native.rglob("*")}
    code = (
        "import json, sys\n"
        "from pathlib import Path\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import stellard_tpu_torch.native as n\n"
        f"n.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "lib = n.load_native()\n"
        "from stellard_tpu_torch.nodestore import make_database\n"
        f"db = make_database(type='segstore', path={str(tmp_path / 'ns')!r})\n"
        "db.close()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('stellard_tpu.')]\n"
        "print(json.dumps([lib is not None, str(n.lib_path()), bad]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    built, path, bad = json.loads(r.stdout.strip().splitlines()[-1])
    assert bad == []
    if built:
        assert Path(path).parent == tmp_path and Path(path).exists()
    after = {p: (p.stat().st_size, p.stat().st_mtime_ns) for p in native.rglob("*")}
    assert after == before


def test_the_close_slice_adds_sqlite3_and_no_other_storage():
    """The default close's modules import nothing outside the package
    but the standard library's helpers and sqlite3 (the txdb's and the
    CLF's engine): no other database, and nothing of JAX."""
    roots = {}
    for mod in CLOSE_SLICE:
        path = REPO / (mod.replace(".", "/") + ".py")
        names = set(_imported_names(ast.parse(path.read_text(), filename=str(path))))
        roots[mod] = {n.split(".")[0] for n in names if not n.startswith("stellard_tpu_torch")}
    extra = {mod: r - CLOSE_SLICE_IMPORTS for mod, r in roots.items()}
    assert all(not e for e in extra.values()), extra
    assert {mod for mod, r in roots.items() if "sqlite3" in r} == {
        "stellard_tpu_torch.node.txdb", "stellard_tpu_torch.state.clf"}

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
    # and so is the standalone node's: config, node, brain, queues, doors
    assert set(NODE_SLICE) <= set(mods)
    # and so is consensus's: the round, the wire, the simulated overlay,
    # the validator, catch-up and tree sync
    assert set(CONSENSUS_SLICE) <= set(mods)
    # and so is the networked validator's: the TCP overlay, its TLS and
    # discovery, the SNTP clock, the list sources and the test kit
    assert set(NETWORK_SLICE) <= set(mods)
    # and so is the out-of-core state's: history shards, the cleaner and
    # online deletion
    assert set(OOC_SLICE) <= set(mods)
    # and so is the device width's: the mesh and its dry run
    assert set(WIDTH_SLICE) <= set(mods)
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


# the modules the standalone node's slice added
NODE_SLICE = tuple(f"stellard_tpu_torch.{m}" for m in (
    "utils.rfc1751", "utils.pow", "utils.fatal", "protocol.stparsedjson", "node.config",
    "node.jobqueue", "node.loadmgr", "node.localtxs", "node.txq", "node.networkops",
    "node.unl", "overlay", "overlay.resource", "rpc", "rpc.errors", "rpc.txsign",
    "rpc.infosub", "rpc.readplane", "rpc.handlers", "rpc.http_server", "rpc.ws_server",
    "__main__"))


# the modules the consensus slice added
CONSENSUS_SLICE = tuple(f"stellard_tpu_torch.{m}" for m in (
    "consensus", "consensus.consensus", "consensus.disputed", "consensus.proposal",
    "consensus.timing", "consensus.txset", "consensus.validation",
    "consensus.validations", "consensus.voting", "overlay.proto", "overlay.wire",
    "overlay.squelch", "overlay.followertree", "overlay.simnet", "node.validator",
    "node.inbound", "state.shamapsync"))


# the modules the networked validator's slice added
NETWORK_SLICE = tuple(f"stellard_tpu_torch.{m}" for m in (
    "overlay.tcp", "overlay.peerfinder", "overlay.peertls", "node.netclock",
    "node.sitefiles", "testkit", "testkit.tcpnet", "testkit.schedule", "testkit.workloads"))


# the modules the out-of-core state's slice added (and the lazy tree it
# extends)
OOC_SLICE = tuple(f"stellard_tpu_torch.{m}" for m in (
    "nodestore.shards", "node.ledgercleaner", "state.shamap", "state.hotcache"))


# the modules the device width's slice added or widened: the mesh, the
# backends over it, the planes' arms and the multichip dry run
WIDTH_SLICE = tuple(f"stellard_tpu_torch.{m}" for m in (
    "parallel", "parallel.mesh", "crypto.backend", "node.verifyplane", "entry",
    "ops.ed25519", "ops.ed25519_cuda"))


# the modules the fleet roles' slice added: the archive tier, the health
# watchdog and flight recorder, the HTTP-push subscriber (and the node
# that wires them), and the txdb's and CLF's multi-row writes
FLEET_SLICE = tuple(f"stellard_tpu_torch.{m}" for m in (
    "node.archive", "node.health", "rpc.rpcsub", "node.node", "utils.sqlrows"))


# the modules the speculation pool's slice added: the Block-STM executor
# and its ring transport
SPEC_SLICE = tuple(f"stellard_tpu_torch.{m}" for m in ("engine.specexec", "engine.specring"))


# the modules the scenario kit's slice added: the hostile slots, the
# runner and its scorecard, the matrix and corpus, the search plane
SCENARIO_SLICE = tuple(f"stellard_tpu_torch.{m}" for m in (
    "testkit.byzantine", "testkit.scenario", "testkit.scenarios", "testkit.search"))


def test_the_scenario_slice_imports_neither_jax_nor_the_jax_package():
    """The same for the scenario kit's slice, and its corpus is the
    port's own copy: ``CORPUS_DIR`` lies inside the port's package."""
    assert set(SCENARIO_SLICE) <= set(_modules())
    slice_imports_neither_jax_nor_the_jax_package(SCENARIO_SLICE)
    from stellard_tpu_torch.testkit.scenarios import CORPUS_DIR

    assert Path(CORPUS_DIR).resolve().is_relative_to(PKG.resolve())
    assert sorted(Path(CORPUS_DIR).glob("*.json"))


def test_the_spec_slice_imports_neither_jax_nor_the_jax_package():
    """The same for the speculation pool's slice: ``engine/specexec.py``
    and ``engine/specring.py``, copies of the JAX modules' behaviour that
    import nothing of them."""
    assert set(SPEC_SLICE) <= set(_modules())
    slice_imports_neither_jax_nor_the_jax_package(SPEC_SLICE)


def test_the_spec_slice_imports_no_torch():
    """A process worker of the pool is a fork of a node that may hold a
    CUDA context, and must never reach the card: importing the executor
    and its ring (everything a worker runs) leaves ``torch`` out of
    sys.modules, as it does the JAX package and ``jax``."""
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for m in {list(SPEC_SLICE)!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'stellard_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_the_consensus_slice_imports_neither_jax_nor_the_jax_package():
    """Importing the consensus slice's modules alone (the SimNet and the
    validator pull in the ledger, engine and node modules they run on)
    leaves jax and the JAX package out of sys.modules, and no source of
    the slice names either."""
    slice_imports_neither_jax_nor_the_jax_package(CONSENSUS_SLICE)


def test_the_networked_slice_imports_neither_jax_nor_the_jax_package():
    """The same for the networked validator's slice: the TCP overlay
    (which builds the validator on the verify plane and hasher), its TLS
    and peer discovery, the SNTP clock, the validator list sources and
    the test kit that launches port validator processes."""
    slice_imports_neither_jax_nor_the_jax_package(NETWORK_SLICE)


def test_the_out_of_core_slice_imports_neither_jax_nor_the_jax_package():
    """The same for the out-of-core state's slice: the history shards
    (with the port's own native record scan), the ledger cleaner and
    online deletion, and the lazy tree."""
    slice_imports_neither_jax_nor_the_jax_package(OOC_SLICE)


def test_the_width_slice_imports_neither_jax_nor_the_jax_package():
    """The same for the device width's slice: ``parallel/`` (the mesh
    over a list of devices, verify_and_count), the backends and planes
    with their one-card and N-card arms, K1's point check and
    ``entry.dryrun_multichip``."""
    slice_imports_neither_jax_nor_the_jax_package(WIDTH_SLICE)


def test_the_fleet_slice_imports_neither_jax_nor_the_jax_package():
    """The same for the fleet roles' slice: ``node/archive.py`` (the
    shard backfill and the never-trimming txdb), ``node/health.py`` and
    ``rpc/rpcsub.py``, each a copy of the JAX module's behaviour that
    imports nothing of it."""
    slice_imports_neither_jax_nor_the_jax_package(FLEET_SLICE)


def slice_imports_neither_jax_nor_the_jax_package(modules) -> None:
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for m in {list(modules)!r}:\n"
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
    for mod in modules:
        path = REPO / mod.replace(".", "/")
        path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
        roots = {n.split(".")[0] for n in _imported_names(ast.parse(path.read_text()))}
        assert not roots & {"jax", "jaxlib", "stellard_tpu"}, mod


def test_the_cli_imports_neither_jax_nor_the_jax_package():
    """`python -m stellard_tpu_torch --help` answers, and running the CLI
    module (its help) leaves jax and the JAX package out of sys.modules."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "stellard_tpu_torch", "--help"],
                       capture_output=True, text=True, timeout=300, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "stellard-tpu-torch" in r.stdout and "--conf" in r.stdout
    code = (
        "import json, runpy, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "sys.argv = ['stellard_tpu_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('stellard_tpu_torch', run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "import stellard_tpu_torch.node.node, stellard_tpu_torch.rpc.handlers\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'stellard_tpu.'))\n"
        "             or m == 'stellard_tpu')\n"
        "print(json.dumps(bad))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


# the modules of the default close's slice, and the only modules outside
# the package they may import: the standard library's threading, timing
# and typing helpers, and sqlite3 as their one storage engine
CLOSE_SLICE = ("stellard_tpu_torch.node.metrics", "stellard_tpu_torch.node.txdb",
               "stellard_tpu_torch.state.clf", "stellard_tpu_torch.node.node",
               "stellard_tpu_torch.node.closepipeline", "stellard_tpu_torch.state.specview",
               "stellard_tpu_torch.engine.deltareplay", "stellard_tpu_torch.node.ledgermaster")
# (since the standalone node: the metrics plane's statsd export over UDP
# and its history ring, and the node's identity file and free-disk check;
# since the networked node: its TLS state directory without a database)
CLOSE_SLICE_IMPORTS = {"__future__", "bisect", "contextlib", "dataclasses", "logging",
                       "sqlite3", "threading", "time", "typing",
                       "collections", "socket", "json", "os", "shutil", "tempfile"}


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


def test_host_libraries_build_into_the_build_dir_and_never_under_native(tmp_path):
    """The native host code (the host crypto library and the ``_stser``
    extension) builds with g++ into the port's build directory, never
    with ``make`` and never under native/; each arm then runs (h prep,
    the native verifier, the codec, the pack and the merge; the ``cpp``
    hasher name too) with nothing of JAX imported; a status read before
    the builds builds nothing."""
    native = REPO / "native"
    before = {p: (p.stat().st_size, p.stat().st_mtime_ns) for p in native.rglob("*")}
    code = (
        "import json, subprocess, sys\n"
        "from pathlib import Path\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "ran = []\n"
        "real_run = subprocess.run\n"
        "def run(cmd, *a, **k):\n"
        "    ran.append(Path(cmd[0]).name)\n"
        "    return real_run(cmd, *a, **k)\n"
        "subprocess.run = run\n"
        "import stellard_tpu_torch.native as n\n"
        f"n.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "unbuilt = (n.arms(), n.status())\n"
        "status = n.build_all()\n"
        "arms = n.arms()\n"
        "from stellard_tpu_torch.crypto.backend import VerifyRequest, make_hasher, make_verifier\n"
        "from stellard_tpu_torch.protocol.keys import KeyPair\n"
        "from stellard_tpu_torch.protocol.stobject import STObject\n"
        "from stellard_tpu_torch.protocol.sfields import sfSequence\n"
        "from stellard_tpu_torch.state.shamap import SHAMap, SHAMapItem\n"
        "from stellard_tpu_torch.ops.ed25519 import prepare_batch\n"
        "k = KeyPair.from_passphrase('hygiene'); m = bytes(32); s = k.sign(m)\n"
        "ok = bool(make_verifier('native').verify_batch([VerifyRequest(k.public, m, s)])[0])\n"
        "h = prepare_batch([k.public], [m], [s])['h_bytes'].tobytes().hex()\n"
        "o = STObject(); o[sfSequence] = 7\n"
        "codec = STObject.from_bytes(o.serialize()).serialize() == o.serialize()\n"
        "t = SHAMap(hash_batch=make_hasher('cpp'))\n"
        "t.bulk_update([SHAMapItem(bytes([i]) * 32, b'v') for i in range(40)])\n"
        "root = t.get_hash().hex()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('stellard_tpu.')]\n"
        "print(json.dumps([unbuilt, status, arms, ran, ok, codec, bad, len(root)]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    unbuilt, status, arms, ran, ok, codec, bad, root_len = json.loads(
        r.stdout.strip().splitlines()[-1])
    assert bad == [] and "make" not in ran
    assert unbuilt == [{"h_prep": False, "native_verify": False, "codec": False,
                       "pack": False, "merge": False, "libraries": {}}, {}]
    if all(not v.startswith("unavailable") for v in status.values()):
        assert set(status) == {"nodestore", "host", "stser"}
        for path in status.values():
            assert Path(path).parent == tmp_path and Path(path).exists()
        assert all(arms[k] for k in ("h_prep", "native_verify", "codec", "pack", "merge"))
        assert ok and codec and root_len == 64
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

"""CLI entry point: `python -m stellard_tpu_torch [options]`.

Reference: src/ripple_app/main/Main.cpp:157-412 — server mode,
`--standalone`/`-a`, `--conf`, `--start` (fresh genesis), plus an RPC
client mode (`python -m stellard_tpu_torch ping`, Main.cpp:400-405 RPCCall).

The node is a standalone node, or a networked validator when its config
has ``[peer_port]`` and ``[standalone] 0``: ``--start`` then serves its
doors, joins the TCP net and runs until stopped. Its device backend is
``cuda``, so ``python -m stellard_tpu_torch -a --start`` runs on the card
unless the config's ``[signature_backend]`` and ``[hash_backend]`` say
``type=cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request


def main(argv: list[str] | None = None) -> int:
    from .utils.fatal import install as install_fatal_reporter

    install_fatal_reporter()
    ap = argparse.ArgumentParser(prog="stellard-tpu-torch")
    ap.add_argument("--conf", default="", help="config file (INI sections)")
    ap.add_argument("-a", "--standalone", action="store_true",
                    help="no network; manual ledger closes")
    ap.add_argument("--start", action="store_true", help="fresh genesis")
    ap.add_argument("--rpc_ip", default=None)
    ap.add_argument("--rpc_port", type=int, default=None)
    ap.add_argument("--websocket_port", type=int, default=None)
    ap.add_argument("--dump_ledger", metavar="SEQ", type=int, default=None,
                    help="print stored ledger SEQ as JSON and exit")
    ap.add_argument("--dump_transactions", metavar="FILE", default=None,
                    help="stream stored txns to FILE as JSON lines and exit")
    ap.add_argument("--load_transactions", metavar="FILE", default=None,
                    help="re-drive a transaction dump through a fresh chain")
    ap.add_argument("--ledger", metavar="SEQ", type=int, default=None,
                    help="with --replay: the ledger to re-close")
    ap.add_argument("--import_db", metavar="TYPE[:PATH]", default=None,
                    help="migrate every node object from another NodeStore "
                         "backend into the configured one (reference: "
                         "--import, Application.cpp:320-323,1403)")
    ap.add_argument("--sustain", action="store_true",
                    help="supervisor mode: restart the server if it "
                         "crashes (reference: DoSustain, Main.cpp:261-275)")
    ap.add_argument("--replay", action="store_true",
                    help="replay stored ledger --ledger and verify its hash")
    ap.add_argument("--unittest", metavar="PATTERN", nargs="?", const="",
                    default=None,
                    help="run the test suite (optionally filtered by "
                         "PATTERN) and exit (reference: Main.cpp:293-301)")
    ap.add_argument("command", nargs="*", help="RPC client command")
    args = ap.parse_args(argv)

    if args.unittest is not None:
        # reference: `stellard --unittest [pattern]` runs the in-source
        # suites with a memory NodeStore; here it is this package's own
        # pytest files, tests/test_torch_*.py
        import glob
        import os
        import subprocess

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        if not os.path.isdir(os.path.join(repo, "tests")):
            print("--unittest: no tests/ beside the package (installed "
                  "copy?) — run pytest from a source checkout",
                  file=sys.stderr)
            return 1
        files = sorted(glob.glob(os.path.join(repo, "tests", "test_torch_*.py")))
        cmd = [sys.executable, "-m", "pytest", *files, "-q"]
        if args.unittest:
            cmd += ["-k", args.unittest]
        return subprocess.call(cmd, cwd=repo)

    from .node.config import Config

    if args.conf:
        with open(args.conf) as fh:
            cfg = Config.from_ini(fh.read())
    else:
        cfg = Config()
    if args.standalone:
        cfg.standalone = True
    if args.start:
        cfg.start_up = "fresh"
    if args.rpc_ip:
        cfg.rpc_ip = args.rpc_ip
    if args.rpc_port is not None:
        cfg.rpc_port = args.rpc_port
    if args.websocket_port is not None:
        cfg.websocket_port = args.websocket_port

    if args.command:
        # RPC client mode (reference: RPCCall::fromCommandLine)
        method, *rest = args.command
        params: dict = {}
        for arg in rest:
            if "=" in arg:
                k, v = arg.split("=", 1)
                params[k] = v
            else:
                params.setdefault("args", []).append(arg)
        scheme = "https" if cfg.rpc_secure else "http"
        url = f"{scheme}://{cfg.rpc_ip}:{cfg.rpc_port or 5005}/"
        body = json.dumps({"method": method, "params": [params]}).encode()
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"}
        )
        ssl_ctx = None
        if cfg.rpc_secure:
            # the server cert is a self-signed transport artifact
            # (reference RPCCall over [rpc_secure] likewise skips
            # verification for the loopback admin connection)
            import ssl as _ssl

            ssl_ctx = _ssl.SSLContext(_ssl.PROTOCOL_TLS_CLIENT)
            ssl_ctx.check_hostname = False
            ssl_ctx.verify_mode = _ssl.CERT_NONE
        with urllib.request.urlopen(req, context=ssl_ctx) as resp:
            print(json.dumps(json.load(resp), indent=2))
        return 0

    if args.import_db:
        return _import_nodestore(args.import_db, cfg)

    if (
        args.dump_ledger is not None
        or args.dump_transactions
        or args.load_transactions
        or args.replay
    ):
        return _offline_tools(args, cfg)

    if args.sustain:
        return _sustain(argv)

    from .node.node import Node

    if cfg.rpc_port is None:
        cfg.rpc_port = 5005
    if cfg.websocket_port is None:
        cfg.websocket_port = 6006
    node = Node(cfg).setup().serve()
    rpc_scheme = "https" if cfg.rpc_secure else "http"
    ws_scheme = "wss" if cfg.websocket_secure else "ws"
    print(
        f"stellard-tpu-torch: rpc {rpc_scheme}://{cfg.rpc_ip}:{node.http_server.port} "
        f"ws {ws_scheme}://{cfg.websocket_ip}:{node.ws_server.port} "
        f"(standalone={cfg.standalone}, "
        f"signature_backend={cfg.signature_backend})",
        file=sys.stderr,
    )
    # graceful SIGTERM (reference: signalStop wiring): the run loop exits
    # and the finally-teardown drains the ordered persist queue — a
    # supervisor's TERM must not drop ledgers the RPC already reported
    # committed
    import signal

    signal.signal(signal.SIGTERM, lambda _s, _f: node._running.clear())
    try:
        node.run()
    except KeyboardInterrupt:
        pass
    finally:
        node.stop()
    return 0


def _import_nodestore(spec: str, cfg) -> int:
    """Copy every object from another backend into the configured main
    store (reference: --import NodeStore migration)."""
    from .nodestore.core import make_database

    src_type, _, src_path = spec.partition(":")
    if cfg.node_db_type in ("memory", "null"):
        print("import: destination [node_db] is non-persistent "
              f"({cfg.node_db_type!r}) — configure a real backend",
              file=sys.stderr)
        return 1
    if src_type in ("sqlite", "cpplog") and not src_path:
        print(f"import: source {src_type!r} needs a path "
              "(TYPE:PATH)", file=sys.stderr)
        return 1
    source = make_database(
        type=src_type, **({"path": src_path} if src_path else {}),
        async_writes=False,
    )
    dest = make_database(
        type=cfg.node_db_type,
        **({"path": cfg.node_db_path} if cfg.node_db_path else {}),
        async_writes=False,
    )
    n = 0
    chunk = []
    for obj in source.backend.iterate():
        chunk.append(obj)
        n += 1
        if len(chunk) >= 4096:
            dest.backend.store_batch(chunk)  # one commit per chunk
            chunk = []
    if chunk:
        dest.backend.store_batch(chunk)
    dest.close()
    source.close()
    print(f"imported {n} node objects from {spec} "
          f"into {cfg.node_db_type}", file=sys.stderr)
    return 0


def _sustain(argv: list[str] | None) -> int:
    """Supervisor loop: re-exec the server child until it exits cleanly
    (reference: DoSustain — the parent process restarts a crashed child).
    """
    import subprocess
    import time as _time

    child_args = [a for a in (argv if argv is not None else sys.argv[1:])
                  if a != "--sustain"]
    cmd = [sys.executable, "-m", "stellard_tpu_torch"] + child_args
    restarts = 0
    while True:
        rc = subprocess.call(cmd)
        if rc == 0:
            return 0
        restarts += 1
        print(f"sustain: child exited rc={rc}; restart #{restarts}",
              file=sys.stderr)
        _time.sleep(min(30, restarts))


def _offline_tools(args, cfg) -> int:
    """Offline modes (reference: LedgerDump.cpp entry points)."""
    from .node.ledgertools import (
        dump_ledger,
        dump_transactions,
        load_transactions,
        replay_ledger,
    )
    from .node.txdb import TxDatabase
    from .nodestore.core import make_database
    from .state.ledger import Ledger

    db = make_database(
        type=cfg.node_db_type,
        **({"path": cfg.node_db_path} if cfg.node_db_path else {}),
    )
    txdb = TxDatabase(cfg.database_path or ":memory:")

    def ledger_by_seq(seq: int) -> Ledger:
        hdr = txdb.get_ledger_header(seq=seq)
        if hdr is None:
            raise SystemExit(f"no stored ledger {seq}")
        return Ledger.load(db, hdr["hash"])

    if args.dump_ledger is not None:
        print(json.dumps(dump_ledger(ledger_by_seq(args.dump_ledger)), indent=2))
        return 0
    if args.dump_transactions:
        seqs = [s for s in txdb.ledger_seqs() if s >= 2]
        gaps = [
            (a, b) for a, b in zip(seqs, seqs[1:]) if b != a + 1
        ]
        for a, b in gaps:
            print(f"warning: ledger gap {a} → {b} (catch-up switch?)",
                  file=sys.stderr)

        def ledgers():
            for seq in seqs:
                hdr = txdb.get_ledger_header(seq=seq)
                if hdr is not None:
                    yield Ledger.load(db, hdr["hash"])

        with open(args.dump_transactions, "w") as fh:
            n = dump_transactions(ledgers(), fh)
        print(f"dumped {n} transactions from {len(seqs)} ledgers",
              file=sys.stderr)
        return 0
    if args.load_transactions:
        from .node.ledgermaster import LedgerMaster
        from .node.node import MASTER_PASSPHRASE
        from .protocol.keys import KeyPair

        lm = LedgerMaster()
        lm.start_new_ledger(
            KeyPair.from_passphrase(MASTER_PASSPHRASE).account_id
        )
        with open(args.load_transactions) as fh:
            applied, failed = load_transactions(fh, lm)
        print(f"applied {applied}, failed {failed}", file=sys.stderr)
        return 0
    if args.replay:
        if args.ledger is None:
            raise SystemExit("--replay requires --ledger SEQ")
        hdr = txdb.get_ledger_header(seq=args.ledger)
        if hdr is None:
            raise SystemExit(f"no stored ledger {args.ledger}")
        # replay through the CONFIGURED hash/signature backends — this is
        # the BASELINE #5 harness, so it must measure the device pipeline
        # (batched re-verification is the catch-up trust model)
        from .crypto.backend import make_hasher
        from .node.verifyplane import VerifyPlane

        hasher = make_hasher(
            cfg.hash_backend,
            **({"mesh": cfg.hash_mesh, "device": cfg.hash_device}
               if cfg.hash_backend == "cuda" else {}),
        )
        plane = VerifyPlane(backend=cfg.signature_backend, window_ms=1.0,
                            backend_opts=cfg.verify_backend_opts())
        stats = replay_ledger(db, hdr["hash"], hash_batch=hasher,
                              verify_many=plane.verify_many)
        # routing evidence: without this, latency-aware routing could
        # verify everything on the CPU while the harness claims a
        # device-pipeline measurement
        pj = plane.get_json()
        stats["device_share"] = pj.get("device_share", 0.0)
        stats["device_sigs"] = pj.get("device_sigs", 0)
        plane.stop()
        print(json.dumps(stats, indent=2))
        return 0 if stats["ok"] else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

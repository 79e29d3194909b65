"""The port's ledger cleaner against the JAX package's.

tests/test_cleaner_repair.py (a victim node whose store lost every
ledger re-acquires them from a peer through the cleaner's repair
requests on ``InboundLedgers`` and re-persists them) and
tests/test_rpc_surface.py::test_ledger_cleaner_runs_clean (the admin
``ledger_cleaner`` command over a clean history) run twice here: once as
they are (the JAX package) and once with the port's names, each node's
close times pinned to its closing ledger's sequence. Both runs must pass,
and every cleaner's end state (checked, failures and their problems,
repairs requested and done) and every ``ledger_cleaner`` answer but the
status polls, whose number follows the wall clock, must be equal.

Online deletion, through the node: the node cases of
tests/test_segstore.py (TestNodeDbConfig, TestNodeOnSegstore,
TestSqlTrim) run on both packages, and a standalone node of each,
sweeping into history shards as it closes, answers get_counts'
online-deletion and shard blocks and account_tx below, across and above
the retained floor equally, writes the same shard files, and serves them
through a networked node's segment manifest.
"""

from __future__ import annotations

import pytest

import stellard_tpu.node.ledgercleaner as jax_cleaner
import stellard_tpu_torch.node.ledgercleaner as port_cleaner
import stellard_tpu_torch.nodestore.shards as port_shards
import test_cleaner_repair as tcr
import test_rpc_surface as tsu
from stellard_tpu_torch.node.node import Node as PortNode
from test_torch_consensus import port_twin
from test_torch_rpc import PORT_INLINE, pinned, port_names
from test_torch_txq import CpuConfig, run_method

CLEANER = {"jax": jax_cleaner.LedgerCleaner, "port": port_cleaner.LedgerCleaner}


def watched(mp, pkg: str, made: list) -> None:
    cls = CLEANER[pkg]

    def init(obj, *a, _init=cls.__init__, **kw):
        _init(obj, *a, **kw)
        made.append(obj)

    mp.setattr(cls, "__init__", init)


def test_missing_ledgers_reacquired_from_peer_equal_to_jax(tmp_path):
    ends = {}
    for pkg in ("jax", "port"):
        path = tmp_path / pkg
        path.mkdir()
        made: list = []
        with pytest.MonkeyPatch.context() as mp:
            watched(mp, pkg, made)
            if pkg == "jax":
                mod = tcr
                mp.setattr(mod, "Node", pinned(mod.Node))
            else:
                mod = port_twin("test_cleaner_repair")
                mp.setattr(mod, "Config", CpuConfig)
                mp.setattr(mod, "Node", pinned(PortNode))
            run_method(mod, mod.TestCleanerRepair,
                       "test_missing_ledgers_reacquired_from_peer", tmp_path=path)
        ends[pkg] = [c.get_json() for c in made]
    victim = ends["jax"][1]
    assert victim["repaired"] >= 1 and victim["failure_count"] >= 2
    assert ends["port"] == ends["jax"]


def test_ledger_cleaner_runs_clean_equal_to_jax(tmp_path):
    logs = {}
    for pkg in ("jax", "port"):
        path = tmp_path / pkg
        path.mkdir()
        made: list = []
        answers: list = []
        with pytest.MonkeyPatch.context() as mp:
            watched(mp, pkg, made)
            if pkg == "jax":
                mp.setattr(tsu, "Node", pinned(tsu.Node))
            else:
                for attr, obj in port_names(tsu).items():
                    mp.setattr(tsu, attr, obj)
                for mod, attr, obj in PORT_INLINE:
                    mp.setattr(mod, attr, obj)
            call = tsu.call

            def logged(node, method, **params):
                r = call(node, method, **params)
                if method == "ledger_cleaner" and not params.get("status"):
                    answers.append(r)
                return r

            mp.setattr(tsu, "call", logged)
            run_method(tsu, tsu.TestNewHandlers, "test_ledger_cleaner_runs_clean",
                       tmp_path=path)
        logs[pkg] = (answers, [c.get_json() for c in made])
    assert logs["jax"][0][0]["status"] == "started"
    assert logs["port"] == logs["jax"]


# -- online deletion: the node cases of tests/test_segstore.py ---------------

import stellard_tpu.node.config as jax_config  # noqa: E402
import stellard_tpu.node.node as jax_node  # noqa: E402
import stellard_tpu_torch.node.config as port_config  # noqa: E402
import stellard_tpu_torch.node.node as port_node  # noqa: E402
import test_segstore as ts  # noqa: E402
from test_torch_consensus import cases  # noqa: E402

NODE_CASES = [p for p in cases(ts) if p.values[0] in ("TestNodeDbConfig", "TestNodeOnSegstore",
                                                       "TestSqlTrim")]
PLANES = {"jax": (jax_config, jax_node), "port": (port_config, port_node)}


def recording_node(node_cls, log: list):
    """``node_cls`` with close times pinned to the closing ledger's
    sequence, logging the last closed ledger and the online deleter's
    settings when it stops."""
    base = pinned(node_cls)

    class Recorded(base):
        def stop(self):
            lcl = self.ledger_master.closed_ledger()
            od = self.online_deleter
            log.append((lcl.seq, lcl.hash().hex(),
                        None if od is None else (od.retain, od.interval, od.sql_trim)))
            super().stop()

    return Recorded


@pytest.mark.parametrize(("cname", "mname", "kwargs"), NODE_CASES)
def test_segstore_node_case_equal_to_jax(cname, mname, kwargs, tmp_path):
    """The case on both packages (the port's Config on host crypto
    planes, the JAX Config's default): both pass, and every node they
    made closed the same last ledger with the same deleter."""
    logs = {}
    for pkg in ("jax", "port"):
        path = tmp_path / pkg
        path.mkdir()
        log: list = []
        config, node = PLANES[pkg]
        mod = ts if pkg == "jax" else port_twin("test_segstore")
        with pytest.MonkeyPatch.context() as mp:
            if pkg == "port":
                mp.setattr(config, "Config", CpuConfig)
            mp.setattr(node, "Node", recording_node(node.Node, log))
            run_method(mod, getattr(mod, cname), mname, tmp_path=path, kwargs=kwargs)
        logs[pkg] = log
    assert logs["port"] == logs["jax"]
    if cname == "TestNodeOnSegstore":
        assert logs["jax"][0][0] == 9 and logs["jax"][0][2] == (3, 2, True)


def test_segstore_node_cases_cover_the_three_classes():
    assert len(NODE_CASES) == 6


# -- online deletion into history shards, through the node -------------------


def shard_flood(pkg: str, tmp_path) -> dict:
    """A standalone node of package `pkg` on segstore with online
    deletion (retain 3, a sweep every 2 validated ledgers) sealing into
    history shards: 8 closes of 12 payments, each close persisted and
    its sweep (if one starts) landed before the next, so the sweeps are
    the same in both packages. -> its get_counts' online-deletion and
    shard blocks, account_tx answers below, across and above the
    retained floor (rows from the shards carry "shard"), and every
    closed ledger's hash."""
    import time

    from stellard_tpu_torch.protocol.keys import KeyPair

    config, node_mod = PLANES[pkg]
    cfg_cls = config.Config if pkg == "jax" else CpuConfig
    root = "stellard_tpu" if pkg == "jax" else "stellard_tpu_torch"
    fmt = __import__(f"{root}.protocol.formats", fromlist=["TxType"])
    sf = __import__(f"{root}.protocol.sfields", fromlist=["sfAmount"])
    amt = __import__(f"{root}.protocol.stamount", fromlist=["STAmount"])
    sttx = __import__(f"{root}.protocol.sttx", fromlist=["SerializedTransaction"])
    rpc = __import__(f"{root}.rpc.handlers", fromlist=["dispatch"])
    stores = dict(node_db_type="segstore", node_db_path=str(tmp_path / "nodestore"),
                  node_db_segment_mb=1, node_db_shards="1",
                  database_path=str(tmp_path / "stellard.db"))
    node = pinned(node_mod.Node)(cfg_cls(
        node_db_online_delete=3, node_db_online_delete_interval=2, **stores)).setup()
    call = lambda method, **p: rpc.dispatch(  # noqa: E731
        rpc.Context(node, p, rpc.Role.ADMIN), method)
    master = KeyPair.from_passphrase("masterpassphrase")
    dests = [KeyPair.from_passphrase(f"shard-{i}").account_id for i in range(3)]
    hashes = []
    try:
        od = node.online_deleter
        seq = 1
        for _close in range(8):
            for i in range(12):
                tx = sttx.SerializedTransaction.build(
                    fmt.TxType.ttPAYMENT, master.account_id, seq, 10,
                    {sf.sfAmount: amt.STAmount.from_drops(250_000_000),
                     sf.sfDestination: dests[i % len(dests)]})
                tx.sign(master)
                ter, _ = node.submit(tx)
                assert int(ter) == 0, ter
                seq += 1
            node.close_ledger()
            hashes.append(node.ledger_master.closed_ledger().hash().hex())
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                assert node.close_pipeline.flush(timeout=30)
                j = od.get_json()
                if not j["running"] and not od._apply_pending:
                    break
                time.sleep(0.02)
            assert node.close_pipeline.flush(timeout=30)
        counts = call("get_counts")
        acct = master.human_account_id
        answers = [call("account_tx", account=acct, ledger_index_min=lo, ledger_index_max=hi,
                        forward=fw, limit=7)
                   for lo, hi, fw in ((1, 20, True), (1, 20, False), (1, 3, True), (5, -1, True))]
        pages, marker = [], None
        while True:
            page = call("account_tx", account=acct, ledger_index_min=1, ledger_index_max=-1,
                        forward=True, limit=10, **({"marker": marker} if marker else {}))
            pages.append(page)
            marker = page.get("marker")
            if not marker:
                break
    finally:
        node.stop()
    # the same stores under a networked node: its catch-up serves the
    # sealed shards beside the live segments (CombinedSegmentSource)
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        peer_port = sock.getsockname()[1]
    node = node_mod.Node(cfg_cls(standalone=False, peer_port=peer_port, **stores))
    try:
        source = node.overlay.node.segment_source
        shard_segments = [r for r in source.segments()
                          if r["id"] >= port_shards.SHARD_SEG_BASE]
        served = [source.fetch_segment(r["id"]) for r in shard_segments]
    finally:
        node.stop()
    od_json = {k: v for k, v in counts["node_store"]["online_delete"].items()
               if k not in ("last_sweep_ms", "running")}
    return {"online_delete": od_json, "history_shards": counts["history_shards"],
            "account_tx": answers, "pages": pages, "hashes": hashes,
            "source": type(source).__name__, "served": served}


def test_online_delete_into_shards_answers_as_the_jax_node(tmp_path):
    out = {}
    for pkg in ("jax", "port"):
        path = tmp_path / pkg
        path.mkdir()
        out[pkg] = shard_flood(pkg, path)
    jax = out["jax"]
    assert jax["online_delete"]["shards_sealed"] >= 1
    assert jax["history_shards"]["shards"] >= 1
    assert any("shard" in row for row in jax["account_tx"][0]["transactions"])
    assert jax["source"] == "CombinedSegmentSource" and jax["served"]
    assert out["port"] == jax
    files = {pkg: {p.name: p.read_bytes() for p in (tmp_path / pkg).glob("nodestore.shards/*")}
             for pkg in out}
    assert files["jax"] and files["port"] == files["jax"]

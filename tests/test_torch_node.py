"""The port's standalone Node against the JAX package's.

The scenarios of tests/test_node.py (the standalone open/close loop,
held transactions, bad signatures, the coalesced async submit,
persistence with an eager `[start_up] load` resume, the job queue, the
RPC handlers in process, the ledger/transactions/account and server
streams, the verify-once memoization) run through both packages' `Node`,
each with `type=cpu` crypto planes and close times pinned to the closing
ledger's sequence. Every ledger hash, TER, status, RPC answer (but the
named volatile fields), stream message and persisted txdb and CLF row
must be equal: the tolerance is zero, since these are bytes. The CLI
smoke runs `python -m stellard_tpu_torch` as a server subprocess and as
its own RPC client over HTTP: `ping`, `submit`, `ledger_accept`, then the
offline `--dump_ledger` over the stores it left.

Also here: the port's config (the `cuda` defaults, and the keys that
must raise), and its node's refusal to start without a card.
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
import types

import pytest
import torch

import chip_smoke as cs

XRP = 1_000_000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("stellard_tpu", "stellard_tpu_torch")

# fields of an RPC answer that differ between two nodes by construction:
# the build string, the node identity (a random key per node), clocks,
# the random RPC's bytes, and the admission queue's sizes, which its
# capacity model derives from each close's measured wall ms
VOLATILE = frozenset({"build_version", "hostid", "pubkey_node", "uptime", "random",
                      "time", "date_now", "expected_ledger_size", "max_queue_size",
                      "max_size", "txns_expected", "per_tx_close_ms"})


def load(root: str) -> types.SimpleNamespace:
    """One package's names, as the scenarios use them."""
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    pk = types.SimpleNamespace(root=root)
    pk.Node = m("node.node").Node
    pk.ConfigCls = m("node.config").Config
    pk.jobqueue = m("node.jobqueue")
    pk.TxType = m("protocol.formats").TxType
    pk.keys = m("protocol.keys")
    pk.KeyPair = pk.keys.KeyPair
    pk.sf = m("protocol.sfields")
    pk.stamount = m("protocol.stamount")
    pk.STAmount = pk.stamount.STAmount
    pk.STTx = m("protocol.sttx").SerializedTransaction
    pk.TER = m("protocol.ter").TER
    pk.handlers = m("rpc.handlers")
    pk.infosub = m("rpc.infosub")
    pk.Ledger = m("state.ledger").Ledger
    pk.flags = m("engine.flags")
    pk.txsign = m("rpc.txsign")
    return pk


PKG = {root: load(root) for root in PACKAGES}


def config(pk, **kw):
    """A cpu node's Config in either package, each with its default
    health watchdog; the JAX node without its kernel tuning file (this
    package's node has none)."""
    base = {"signature_backend": "cpu", "hash_backend": "cpu"}
    if pk.root == "stellard_tpu":
        base.update(kernel_tuning="none")
    return pk.ConfigCls(**{**base, **kw})


def pin_clock(node) -> None:
    """Close times pinned to the closing ledger's sequence, one
    resolution step a ledger."""
    node.ops.network_time = lambda: 900_000_000 + node.ledger_master.current_ledger().seq * 30


def make_node(pk, serve: bool = False, **kw):
    node = pk.Node(config(pk, **kw)).setup()
    pin_clock(node)
    return node.serve() if serve else node


def scrub(obj, volatile=VOLATILE):
    """An RPC answer without its ``volatile`` fields, at any depth."""
    if isinstance(obj, dict):
        return {k: scrub(v, volatile) for k, v in obj.items() if k not in volatile}
    if isinstance(obj, list):
        return [scrub(v, volatile) for v in obj]
    return obj


def call(pk, node, method, role=None, **params):
    h = pk.handlers
    return h.dispatch(h.Context(node=node, params=params,
                                role=h.Role.ADMIN if role is None else role), method)


def payment(pk, key, seq: int, dest: bytes, drops: int, fee: int = 10):
    tx = pk.STTx.build(pk.TxType.ttPAYMENT, key.account_id, seq, fee,
                       {pk.sf.sfAmount: pk.STAmount.from_drops(drops),
                        pk.sf.sfDestination: dest})
    tx.sign(key)
    return tx


def fund(pk, node, dest, log, drops: int = 1000 * XRP) -> None:
    master = node.master_keys
    led = node.ledger_master.current_ledger()
    seq = pk.txsign.predicted_sequence(
        led, master.account_id, led.account_root(master.account_id)[pk.sf.sfSequence])
    submit(pk, node, payment(pk, master, seq, dest.account_id, drops), log)


def submit(pk, node, tx, log):
    ter, applied = node.submit(tx)
    log.append(("submit", tx.txid().hex(), ter.token, bool(applied),
                int(node.tx_status(tx.txid()) or 0)))
    return ter, applied


def close(pk, node, log):
    closed, results = node.close_ledger()
    log.append(("close", closed.seq, closed.hash().hex(),
                sorted((t.hex(), r.token) for t, r in results.items())))
    return closed, results


def run_both(scenario, **kw) -> list:
    """Run ``scenario(pk, node, log)`` on a fresh node of each package;
    the two logs must be equal. -> the port's log."""
    logs = {}
    for root in PACKAGES:
        pk = PKG[root]
        node = make_node(pk, **kw)
        log: list = []
        try:
            scenario(pk, node, log)
        finally:
            node.stop()
        logs[root] = log
    assert logs["stellard_tpu_torch"] == logs["stellard_tpu"]
    assert logs["stellard_tpu_torch"], "the scenario logged nothing"
    return logs["stellard_tpu_torch"]


def balance(pk, node, kp) -> int:
    return node.ledger_master.current_ledger().account_root(kp.account_id)[
        pk.sf.sfBalance].drops()


# -- TestStandaloneClose ------------------------------------------------------


def test_payment_and_close():
    def scenario(pk, node, log):
        alice = pk.KeyPair.from_passphrase("alice")
        fund(pk, node, alice, log)
        close(pk, node, log)
        log.append(("balance", balance(pk, node, alice)))
        assert balance(pk, node, alice) == 1000 * XRP

    run_both(scenario)


def test_chain_of_closes():
    def scenario(pk, node, log):
        alice = pk.KeyPair.from_passphrase("alice")
        bob = pk.KeyPair.from_passphrase("bob")
        fund(pk, node, alice, log)
        fund(pk, node, bob, log)
        close(pk, node, log)
        for i in range(3):
            ter, _ = submit(pk, node, payment(pk, alice, i + 1, bob.account_id, 10 * XRP), log)
            assert ter == pk.TER.tesSUCCESS
            close(pk, node, log)
        lm = node.ledger_master
        assert balance(pk, node, bob) == 1030 * XRP
        assert lm.closed_ledger().seq == 5
        assert lm.closed_ledger().parent_hash == lm.get_ledger_by_seq(4).hash()

    run_both(scenario)


def test_held_future_seq_applies_after_close():
    def scenario(pk, node, log):
        alice = pk.KeyPair.from_passphrase("alice")
        bob = pk.KeyPair.from_passphrase("bob")
        fund(pk, node, alice, log)
        fund(pk, node, bob, log)
        close(pk, node, log)
        ter, applied = submit(pk, node, payment(pk, alice, 2, bob.account_id, 5 * XRP), log)
        assert ter == pk.TER.terQUEUED and not applied
        ter, _ = submit(pk, node, payment(pk, alice, 1, bob.account_id, 5 * XRP), log)
        assert ter == pk.TER.tesSUCCESS
        close(pk, node, log)
        close(pk, node, log)
        log.append(("balance", balance(pk, node, bob), dict(node.txq.stats)))
        assert balance(pk, node, bob) == 1010 * XRP

    run_both(scenario)


def test_bad_signature_rejected():
    def scenario(pk, node, log):
        alice = pk.KeyPair.from_passphrase("alice")
        tx = payment(pk, node.master_keys, 1, alice.account_id, XRP)
        sig = bytearray(tx.obj[pk.sf.sfTxnSignature])
        sig[5] ^= 0xFF
        tx.obj[pk.sf.sfTxnSignature] = bytes(sig)
        tx._sig_good = None
        ter, applied = submit(pk, node, tx, log)
        assert ter == pk.TER.temINVALID and not applied
        # a known-bad txid is refused at once on resubmit
        ter, applied = submit(pk, node, tx, log)
        assert ter == pk.TER.temINVALID and not applied
        log.append(("stats", node.ops.stats["bad_sig"]))

    run_both(scenario)


def test_async_submit_batches():
    """submit_transaction routes through the VerifyPlane coalescer and
    the ordered intake job; the callbacks' TERs come in submission order."""
    def scenario(pk, node, log):
        alice = pk.KeyPair.from_passphrase("alice")
        bob = pk.KeyPair.from_passphrase("bob")
        fund(pk, node, alice, log)
        close(pk, node, log)
        results, done, n = [], threading.Event(), 20
        for i in range(n):
            def cb(tx, ter, applied):
                results.append((tx.txid().hex(), ter.token, bool(applied)))
                if len(results) == n:
                    done.set()

            node.ops.submit_transaction(payment(pk, alice, i + 1, bob.account_id, XRP), cb)
        assert done.wait(timeout=60)
        log.append(("async", results))
        assert all(t == "tesSUCCESS" for _h, t, _a in results)
        assert node.verify_plane.verified >= n
        close(pk, node, log)

    run_both(scenario)


# -- TestPersistence ----------------------------------------------------------


def test_closed_ledger_saved_and_loadable():
    def scenario(pk, node, log):
        alice = pk.KeyPair.from_passphrase("alice")
        fund(pk, node, alice, log)
        closed, _ = close(pk, node, log)
        loaded = pk.Ledger.load(node.nodestore, closed.hash())
        assert loaded.hash() == closed.hash()
        log.append(("loaded", loaded.account_root(alice.account_id)[pk.sf.sfBalance].drops()))

    run_both(scenario)


def test_tx_history_indexed():
    def scenario(pk, node, log):
        alice = pk.KeyPair.from_passphrase("alice")
        fund(pk, node, alice, log)
        close(pk, node, log)
        rows = node.txdb.account_transactions(alice.account_id)
        assert len(rows) == 1 and rows[0]["status"] == "tesSUCCESS"
        log.append(("rows", repr(rows), repr(node.txdb.get_ledger_header(seq=2))))

    run_both(scenario)


def _file_node(pk, path, start_up: str):
    node = pk.Node(config(pk, node_db_type="sqlite", node_db_path=str(path / "ns.sqlite"),
                          database_path=str(path / "db.sqlite"), start_up=start_up)).setup()
    pin_clock(node)
    return node


@pytest.mark.parametrize("resume", ["clf", "txdb"])
def test_persisted_rows_and_eager_load_resume(tmp_path, resume):
    """A file-backed node closes three ledgers, stops and starts again
    with `[start_up] load` (eager in the port): both packages persist the
    same txdb rows and CLF, and resume the same last closed ledger and
    open ledger, from the CLF pointer or, with the CLF emptied, from the
    txdb's header index."""
    out = {}
    for root in PACKAGES:
        pk = PKG[root]
        path = tmp_path / root
        path.mkdir()
        node, log = _file_node(pk, path, "fresh"), []
        try:
            alice, bob = pk.KeyPair.from_passphrase("alice"), pk.KeyPair.from_passphrase("bob")
            fund(pk, node, alice, log)
            fund(pk, node, bob, log)
            close(pk, node, log)
            for i in range(2):
                submit(pk, node, payment(pk, alice, i + 1, bob.account_id, 7 * XRP), log)
                close(pk, node, log)
            log.append(("txdb", [cs.txdb_digest(node.txdb, s) for s in (1, 2, 3, 4)]))
            log.append(("clf", cs.clf_digest(node.clf)))
            lcl = node.ledger_master.closed_ledger().hash().hex()
        finally:
            node.stop()
        if resume == "txdb":
            clf = path / "db.sqlite.clf"
            assert clf.exists()
            clf.unlink()
        node = _file_node(pk, path, "load")
        try:
            lm = node.ledger_master
            log.append(("resumed", lm.closed_ledger().seq, lm.closed_ledger().hash().hex(),
                        lm.current_ledger().seq))
            assert lm.closed_ledger().hash().hex() == lcl
            submit(pk, node, payment(pk, alice, 3, bob.account_id, XRP), log)
            close(pk, node, log)
        finally:
            node.stop()
        out[root] = log
    assert out["stellard_tpu_torch"] == out["stellard_tpu"]


# -- TestJobQueue -------------------------------------------------------------


def test_job_queue_priority_order():
    order = {}
    for root in PACKAGES:
        jq_mod = PKG[root].jobqueue
        jq = jq_mod.JobQueue(threads=0)
        ran = []
        jq.add_job(jq_mod.JobType.jtCLIENT, "low", lambda r=ran: r.append("low"))
        jq.add_job(jq_mod.JobType.jtACCEPT, "high", lambda r=ran: r.append("high"))
        jq.set_thread_count(1)
        assert jq.drain()
        jq.stop()
        order[root] = ran
    assert order["stellard_tpu_torch"] == order["stellard_tpu"] == ["high", "low"]


def test_job_queue_concurrency_limit():
    peaks = {}
    for root in PACKAGES:
        jq_mod = PKG[root].jobqueue
        jq = jq_mod.JobQueue(threads=4)
        active, peak, lock = [], [], threading.Lock()

        def work():
            with lock:
                active.append(1)
                peak.append(len(active))
            time.sleep(0.05)
            with lock:
                active.pop()

        for _ in range(6):
            jq.add_job(jq_mod.JobType.jtLEDGER_DATA, "limited", work)  # limit 2
        assert jq.drain()
        jq.stop()
        peaks[root] = max(peak)
    assert peaks["stellard_tpu_torch"] <= 2 and peaks["stellard_tpu"] <= 2


# -- TestRpcHandlers ----------------------------------------------------------


def rpc_log(pk, node, log, method, **params):
    r = call(pk, node, method, **params)
    log.append((method, scrub(r)))
    return r


def test_rpc_server_info_and_wallet():
    def scenario(pk, node, log):
        r = rpc_log(pk, node, log, "server_info")
        assert r["info"]["server_state"] == "full"
        assert r["info"]["complete_ledgers"] == "1"
        assert r["info"]["pubkey_node"].startswith("n")
        assert r["info"]["pubkey_validator"] == "none"
        r = rpc_log(pk, node, log, "wallet_propose", passphrase="alice")
        assert r["account_id"] == pk.KeyPair.from_passphrase("alice").human_account_id

    run_both(scenario)


def test_rpc_accounts_submit_sign_and_ledgers():
    def scenario(pk, node, log):
        master = node.master_keys
        alice = pk.KeyPair.from_passphrase("alice")
        rpc_log(pk, node, log, "account_info", account=master.human_account_id)
        r = rpc_log(pk, node, log, "account_info",
                    account=pk.KeyPair.from_passphrase("ghost").human_account_id)
        assert r["error"] == "actNotFound"
        r = rpc_log(pk, node, log, "sign", secret="masterpassphrase", tx_json={
            "TransactionType": "Payment", "Account": master.human_account_id,
            "Destination": alice.human_account_id, "Amount": "1000000"})
        assert "tx_blob" in r
        r = rpc_log(pk, node, log, "submit", secret="masterpassphrase", tx_json={
            "TransactionType": "Payment", "Account": master.human_account_id,
            "Destination": alice.human_account_id, "Amount": str(500 * XRP)})
        assert r["engine_result"] == "tesSUCCESS", r
        tx = payment(pk, master, 2, alice.account_id, 100 * XRP)
        r = rpc_log(pk, node, log, "submit", tx_blob=tx.serialize().hex())
        assert r["engine_result"] == "tesSUCCESS"
        rpc_log(pk, node, log, "ledger_accept")
        node.close_pipeline.flush(timeout=60)
        rpc_log(pk, node, log, "account_info", account=alice.human_account_id)
        rpc_log(pk, node, log, "ledger_closed")
        rpc_log(pk, node, log, "ledger", ledger_index="closed", transactions=True)
        rpc_log(pk, node, log, "ledger", ledger_index=2, transactions=True, expand=True)
        rpc_log(pk, node, log, "ledger_current")
        rpc_log(pk, node, log, "tx", transaction=tx.txid().hex())
        rpc_log(pk, node, log, "account_tx", account=alice.human_account_id)
        rpc_log(pk, node, log, "ledger_entry", account_root=master.human_account_id)
        rpc_log(pk, node, log, "ledger_data", ledger_index="closed", limit=5)
        rpc_log(pk, node, log, "fee")
        assert call(pk, node, "bogus")["error"] == "unknownCmd"

    run_both(scenario)


def test_rpc_account_lines():
    def scenario(pk, node, log):
        alice = pk.KeyPair.from_passphrase("alice")
        gw = pk.KeyPair.from_passphrase("gateway")
        carol = pk.KeyPair.from_passphrase("carol-q")
        for kp in (alice, gw, carol):
            fund(pk, node, kp, log)
        close(pk, node, log)
        usd = pk.STAmount.from_iou(pk.stamount.currency_from_iso("USD"), gw.account_id, 100, 0)
        trust = pk.STTx.build(pk.TxType.ttTRUST_SET, alice.account_id, 1, 10,
                              {pk.sf.sfLimitAmount: usd})
        trust.sign(alice)
        submit(pk, node, trust, log)
        eur = pk.STAmount.from_iou(pk.stamount.currency_from_iso("EUR"), gw.account_id, 500, 0)
        trust = pk.STTx.build(pk.TxType.ttTRUST_SET, carol.account_id, 1, 10, {
            pk.sf.sfLimitAmount: eur, pk.sf.sfQualityIn: 990_000_000,
            pk.sf.sfQualityOut: 1_010_000_000, pk.sf.sfFlags: pk.flags.tfSetNoRipple})
        trust.sign(carol)
        submit(pk, node, trust, log)
        close(pk, node, log)
        for kp in (alice, gw, carol):
            rpc_log(pk, node, log, "account_lines", account=kp.human_account_id)
        r = call(pk, node, "account_lines", account=carol.human_account_id)
        assert r["lines"][0]["quality_in"] == 990_000_000 and r["lines"][0]["no_ripple"] is True

    run_both(scenario)


def test_rpc_get_counts_and_server_state_blocks():
    """get_counts and server_state answer the JAX node's blocks, the
    speculation executor's too, but for the fields that name its device
    and its kernels' launch counts."""
    def scenario(pk, node, log):
        alice = pk.KeyPair.from_passphrase("alice")
        fund(pk, node, alice, log)
        close(pk, node, log)
        counts = call(pk, node, "get_counts")
        assert "verify_plane" in counts
        log.append(("counts", sorted(set(counts) - {"kernels"}),
                    counts["delta_replay"]["spliced"], counts["held"], scrub(counts["txq"]),
                    counts["close_pipeline"]["persisted"], counts["ledgers_cached"],
                    counts["spec"], counts["delta_replay"]["spec"]))
        state = call(pk, node, "server_state")["state"]
        log.append(("state", sorted(state), state["server_state"],
                    state["complete_ledgers"], state.get("validated_ledger"), state["spec"]))

    run_both(scenario)


# -- TestSubscriptions / TestServerStream -------------------------------------


def test_ledger_and_transaction_streams():
    def scenario(pk, node, log):
        subs = pk.infosub.SubscriptionManager(node.ops)
        got = []
        sub = pk.infosub.InfoSub(got.append)
        assert subs.subscribe_streams(sub, ["ledger", "transactions"])["ledger_index"] == 1
        fund(pk, node, pk.KeyPair.from_passphrase("alice"), log)
        close(pk, node, log)
        log.append(("stream", scrub(got)))
        txmsg = next(m for m in got if m["type"] == "transaction")
        assert txmsg["engine_result"] == "tesSUCCESS" and txmsg["validated"] is True

    run_both(scenario)


def test_account_subscription():
    def scenario(pk, node, log):
        subs = pk.infosub.SubscriptionManager(node.ops)
        got = []
        alice = pk.KeyPair.from_passphrase("alice")
        subs.subscribe_accounts(pk.infosub.InfoSub(got.append), [alice.account_id])
        fund(pk, node, pk.KeyPair.from_passphrase("bob"), log)
        close(pk, node, log)
        fund(pk, node, alice, log)
        close(pk, node, log)
        log.append(("stream", scrub(got)))
        assert len([m for m in got if m["type"] == "transaction"]) == 1

    run_both(scenario)


def test_load_change_publishes_server_status():
    def scenario(pk, node, log):
        node.serve()
        got = []
        node.subs.subscribe_streams(pk.infosub.InfoSub(got.append), ["server"])
        node.fee_track.raise_local_fee()
        assert node.subs.flush(timeout=5.0)
        node.fee_track.lower_local_fee()
        assert node.subs.flush(timeout=5.0)
        statuses = [scrub(m) for m in got if m.get("type") == "serverStatus"]
        log.append(("server", statuses))
        assert statuses[0]["load_factor"] > 256 and statuses[-1]["load_factor"] == 256

    run_both(scenario)


# -- TestSigVerifyMemoization ---------------------------------------------------


def test_each_tx_verified_exactly_once(monkeypatch):
    """A tx verified at submit is not verified again at close: the port's
    host verifications (keys.host_verifies: the cpu verify plane's
    native batches and SerializedTransaction.check_sign alike) count one
    a transaction, as the JAX node's do."""
    from stellard_tpu_torch.protocol import keys

    monkeypatch.setattr(keys, "host_verifies", 0)
    pk = PKG["stellard_tpu_torch"]
    node = make_node(pk)
    try:
        alice = pk.KeyPair.from_passphrase("memo-alice")
        for i in range(8):
            ter, _ = node.submit(payment(pk, node.master_keys, i + 1, alice.account_id, 200 * XRP))
            assert ter == pk.TER.tesSUCCESS, ter
        node.close_ledger()
        node.close_ledger()
    finally:
        node.stop()
    assert keys.host_verifies == 8, keys.host_verifies


# -- the config and the card ----------------------------------------------------


def test_config_defaults_to_cuda_and_refuses_unported_planes():
    from stellard_tpu_torch.node.config import Config

    cfg = Config()
    assert (cfg.signature_backend, cfg.hash_backend) == ("cuda", "cuda")
    assert cfg.verify_backend_opts() == {"mesh": "auto", "max_batch": 16384, "device": "cuda"}
    assert Config.from_ini("").signature_backend == "cuda"
    # the device width parses as the JAX package's (0, N or auto)
    cfg = Config.from_ini("[signature_backend]\ntype=cuda\nmesh=2\n"
                          "[hash_backend]\ntype=cuda\nmesh=AUTO\n[paths]\nmesh=4")
    assert (cfg.verify_mesh, cfg.hash_mesh, cfg.paths_mesh) == ("2", "auto", "4")
    for text in (
        "[signature_backend]\ntype=tpu", "[hash_backend]\ntype=tpu",
        "[signature_backend]\ntype=cpp", "[signature_backend]\ntype=cpu\nmesh=2",
        "[hash_backend]\ntype=cuda\nmesh=wide", "[paths]\nmesh=-4",
        "[spec]\nworkers=lots", "[spec]\ntransport=tcp", "[kernel_tuning]\nKERNEL_TUNING.json",
        "[signature_backend]\ntype=cpu\nrouting=device",
        "[signature_backend]\ntype=cpu\nthreads=4",
    ):
        with pytest.raises(ValueError):
            Config.from_ini(text)
    with pytest.raises(ValueError, match="type=cuda"):
        Config.from_ini("[signature_backend]\ntype=tpu")
    # the host backends of the native host code parse as the JAX Config's
    # (tests/test_torch_native_host.py holds each to its value)
    assert Config.from_ini("[hash_backend]\ntype=cpp").hash_backend == "cpp"
    # the speculation pool's keys parse as the JAX Config's
    # (tests/test_torch_specring.py holds each to its value)
    from stellard_tpu.node.config import Config as JaxConfig

    for text in ("[spec]\nworkers=2", "[spec]\nworkers=auto"):
        assert Config.from_ini(text).spec_workers == JaxConfig.from_ini(text).spec_workers
    # the networked validator's keys parse (tests/test_torch_tcp_mixed.py
    # holds each to the JAX Config's value)
    # and so do the out-of-core state's (tests/test_torch_tcp_mixed.py
    # holds each to the JAX Config's value)
    for text in ("[node_db]\nshards=1", "[node_db]\nonline_delete=4", "[tree]\ncache_mb=2"):
        Config.from_ini(text)
    # and the fleet roles' and the health watchdog's, the watchdog on by
    # default as in the JAX package (tests/test_torch_tcp_mixed.py holds
    # each to the JAX Config's value)
    assert Config().health_enabled
    assert Config.from_ini("[node]\nmode=follower").node_mode == "follower"
    assert Config.from_ini("[node]\nmode=archive").node_mode == "archive"
    assert not Config.from_ini("[health]\nenabled=0").health_enabled
    assert Config.from_ini("[health]\nenabled=1").health_enabled
    for text in ("[peer_port]\n51235\n[standalone]\n0", "[rpc_secure]\n1",
                 "[websocket_secure]\n1", "[sntp_servers]\npool.example 123",
                 "[validators_file]\nvalidators.txt"):
        Config.from_ini(text)
    # the device keys reach the factories
    cfg = Config.from_ini("[signature_backend]\ntype=cuda\ndevice=cpu\nmin_device_batch=1\n"
                          "routing=device\n[hash_backend]\ntype=cuda\ndevice=cpu\n"
                          "min_device_nodes=0\nrouting=device\n[spec]\nworkers=1\n"
                          "[peer_port]\n51235\n[standalone]\n1")
    assert cfg.verify_backend_opts()["device"] == "cpu"
    assert (cfg.hash_device, cfg.hash_min_device_nodes, cfg.hash_routing) == ("cpu", 0, "device")
    # a Config built in code is held to the same rule at Node(...), and
    # [spec] workers=4 builds the speculation pool
    from stellard_tpu_torch.node.node import Node

    with pytest.raises(ValueError, match="kernel_tuning"):
        Node(Config(signature_backend="cpu", hash_backend="cpu",
                    kernel_tuning="KERNEL_TUNING.json"))
    node = Node(Config(signature_backend="cpu", hash_backend="cpu", spec_workers=4))
    try:
        ex = node.spec_executor
        assert node.ledger_master.spec_executor is ex
        assert (ex.workers, ex.mode, ex.transport, ex.active) == (4, "process", "ring", True)
        assert len(ex._procs) == 4 and all(w.proc.is_alive() for w in ex._procs)
    finally:
        node.stop()
    assert [w.proc.exitcode for w in ex._procs] == [0] * 4


def test_cuda_node_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from stellard_tpu_torch.node.config import Config
    from stellard_tpu_torch.node.node import Node

    with pytest.raises(RuntimeError, match="cuda"):
        Node(Config())


def test_cuda_node_on_the_cpu_runs_the_plain_kernels(tmp_path):
    """A cuda node on device=cpu: the K1 prewarm, the door's batch-1
    verifies (K1's plain version) and the seal through the watchdog's
    CudaHasher, its readbacks one a tree; the ledger hashes those of a
    cpu node."""
    from stellard_tpu_torch.node.config import Config

    pk = PKG["stellard_tpu_torch"]
    text = ("[signature_backend]\ntype=cuda\ndevice=cpu\nrouting=device\nmin_device_batch=1\n"
            "max_batch=2\n[hash_backend]\ntype=cuda\ndevice=cpu\nrouting=device\n"
            "min_device_nodes=0\n[paths]\nenabled=0\n[rpc_port]\n0\n")
    logs = {}
    for kind in ("cuda", "cpu"):
        cfg = Config.from_ini(text) if kind == "cuda" else config(pk, paths_enabled=False,
                                                                 rpc_port=0)
        node = pk.Node(cfg).setup()
        pin_clock(node)
        log = []
        try:
            node.serve()
            alice = pk.KeyPair.from_passphrase("alice")
            fund(pk, node, alice, log)
            submit(pk, node, payment(pk, node.master_keys, 2, alice.account_id, XRP), log)
            close(pk, node, log)
            if kind == "cuda":
                vp = node.verify_plane.get_json()
                assert vp["device_share"] == 1.0 and vp["cpu_sigs"] == 0
                assert node.verify_plane.prewarm_error is None
                inner = node.hasher.inner
                assert inner.tree_calls > 0
                assert inner.tree_transfers.readbacks == inner.tree_calls
        finally:
            node.stop()
        logs[kind] = log
    assert logs["cuda"] == logs["cpu"]


@pytest.mark.parametrize("fault", ["build", "wedge"])
def test_failed_prewarm_fails_the_start_and_every_device_batch(monkeypatch, fault):
    """A K1 build or launch failure in the prewarm, or a prewarm call
    past its deadline, is not answered from the CPU: serve() raises it,
    and so does each later device batch."""
    from stellard_tpu_torch.crypto import backend
    from stellard_tpu_torch.node.config import Config
    from stellard_tpu_torch.node.node import Node
    from stellard_tpu_torch.utils import devicewatch

    def broken(self, batch):
        if fault == "wedge":
            time.sleep(1.0)
        raise RuntimeError("K1 failed to build")

    monkeypatch.setattr(backend.CudaVerifier, "verify_batch", broken)
    node = Node(Config.from_ini(
        "[signature_backend]\ntype=cuda\ndevice=cpu\nrouting=device\nmax_batch=2\n"
        "device_first_timeout_s=0.2\n[hash_backend]\ntype=cpu\n[paths]\nenabled=0\n"))
    try:
        with pytest.raises(RuntimeError, match="prewarm"):
            node.serve()
        req = backend.VerifyRequest(b"\x01" * 32, b"\x02" * 32, b"\x03" * 64)
        with pytest.raises(RuntimeError, match="prewarm"):
            node.verify_plane.verify_many([req] * 4)
        assert node.verify_plane.cpu_sigs == 0
        assert node.verify_plane.device_wedged == (fault == "wedge")
    finally:
        node.stop()
        devicewatch.HEALTH.reset()  # the wedge verdict is process-wide


def test_cuda_config_keeps_every_batch_on_the_card():
    """A cuda Config sends every signature, hash and path batch to the
    card, the door's single signature included; measured-cost routing,
    which may answer on the host, is an explicit opt-in. The node wires
    these defaults into its planes."""
    from stellard_tpu_torch.crypto.backend import VerifyRequest
    from stellard_tpu_torch.node.config import Config
    from stellard_tpu_torch.node.node import Node

    def routing(cfg):
        return (cfg.verify_routing, cfg.verify_min_device_batch, cfg.hash_routing,
                cfg.hash_min_device_nodes, cfg.paths_routing, cfg.paths_min_device_batch)

    assert routing(Config()) == routing(Config.from_ini("")) == (
        "device", 1, "device", 0, "device", 1)
    cost = Config.from_ini("[signature_backend]\ntype=cuda\nrouting=cost\n[hash_backend]\n"
                           "type=cuda\nrouting=cost\n[paths]\nrouting=cost\n")
    assert (cost.verify_routing, cost.hash_routing, cost.paths_routing) == ("cost",) * 3
    node = Node(Config.from_ini("[signature_backend]\ntype=cuda\ndevice=cpu\nmax_batch=2\n"
                                "[hash_backend]\ntype=cuda\ndevice=cpu\n"))
    try:
        vp, ev = node.verify_plane, node.path_plane.evaluator
        assert (vp.routing, vp.min_device_batch) == ("device", 1)
        assert (node.hasher.routing, node.hasher.min_device_nodes) == ("device", 0)
        assert ev.routing == "device" and ev.get_json()["min_device_batch"] == 1
        node.wait_device_ready()
        sigs = vp.device_sigs
        vp.verify_many([VerifyRequest(b"\x01" * 32, b"\x02" * 32, b"\x03" * 64)])
        assert vp.device_sigs == sigs + 1 and vp.cpu_sigs == 0
    finally:
        node.stop()


def test_a_failed_verify_is_no_verdict_on_the_signature():
    """When the verify plane fails (K1 does not build or launch), both
    submit paths pass the error on and flag nothing against the txid:
    the same transaction goes through once the plane works."""
    from stellard_tpu_torch.node.hashrouter import SF_BAD, SF_SIGGOOD

    pk = PKG["stellard_tpu_torch"]
    node = make_node(pk)
    try:
        alice = pk.KeyPair.from_passphrase("alice")
        tx = payment(pk, node.master_keys, 1, alice.account_id, 1000 * XRP)
        txid = tx.txid()

        def broken(reqs):
            raise RuntimeError("K1 failed to launch")

        node.verify_plane.verify_many = broken
        with pytest.raises(RuntimeError, match="K1 failed"):
            node.submit(tx)
        got, done = [], threading.Event()
        node.ops.submit_transaction(tx, lambda t, ter, applied: (got.append(ter), done.set()))
        assert done.wait(timeout=30)
        assert got == [pk.TER.telLOCAL_ERROR]
        assert node.hash_router.get_flags(txid) & (SF_BAD | SF_SIGGOOD) == 0
        assert node.ops.stats["bad_sig"] == 0 and node.ops.stats["verify_errors"] == 1
        del node.verify_plane.verify_many
        assert node.submit(tx) == (pk.TER.tesSUCCESS, True)
    finally:
        node.stop()


# -- TestCliSmoke ---------------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_cli_server_client_and_offline_dump(tmp_path):
    """`python -m stellard_tpu_torch -a --start --conf <type=cpu>` serves
    `ping`, `submit` and `ledger_accept` over HTTP to its own RPC client
    mode; then `--dump_ledger` reads the stores it left."""
    port = _free_port()
    cfg = tmp_path / "cli.cfg"
    cfg.write_text(f"""
[node_db]
type=sqlite
path={tmp_path}/ns.sqlite

[database_path]
{tmp_path}/db.sqlite

[signature_backend]
type=cpu

[hash_backend]
type=cpu

[rpc_port]
{port}

[websocket_port]
{_free_port()}
""")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cli = [sys.executable, "-m", "stellard_tpu_torch", "--conf", str(cfg)]
    srv = subprocess.Popen(cli + ["-a", "--start"], cwd=REPO, env=env,
                           stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    try:
        def client(*cmd):
            r = subprocess.run(cli + list(cmd), cwd=REPO, env=env, capture_output=True,
                               text=True, timeout=60)
            assert r.returncode == 0, r.stdout + r.stderr
            return json.loads(r.stdout)["result"]

        deadline = time.monotonic() + 120
        pong = None
        while time.monotonic() < deadline:
            try:
                pong = client("ping")
                break
            except (AssertionError, json.JSONDecodeError, subprocess.TimeoutExpired):
                time.sleep(1.0)
        assert pong is not None and pong["status"] == "success"
        info = client("server_info")
        assert info["info"]["complete_ledgers"] == "1"
        assert info["info"]["build_version"].startswith("stellard-tpu-torch")
        pk = PKG["stellard_tpu_torch"]
        master = pk.KeyPair.from_passphrase("masterpassphrase")
        alice = pk.KeyPair.from_passphrase("alice")
        blob = payment(pk, master, 1, alice.account_id, 500 * XRP).serialize().hex()
        sub = client("submit", f"tx_blob={blob}")
        assert sub["engine_result"] == "tesSUCCESS", sub
        accept = client("ledger_accept")
        assert accept["ledger_current_index"] == 3
    finally:
        srv.terminate()
        try:
            srv.wait(timeout=30)
        except subprocess.TimeoutExpired:
            srv.kill()
    r = subprocess.run(cli + ["--dump_ledger", "2"], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    dumped = json.loads(r.stdout)
    assert dumped["ledger_index"] == 2
    assert len(dumped["transactions"]) == 1 and dumped["accountState"]

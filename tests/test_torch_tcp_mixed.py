"""The port's TCP overlay on one net with the JAX package's, and what the
port does differently by design.

- **A mixed net.** Two JAX and two port ``TcpOverlay`` validators on
  localhost, every one on every UNL, quorum 3: no ledger validates
  without a validation from each package. The port's validators verify
  on a ``cpu`` verify plane (the ``verify_many`` seam the card's plane
  takes) and hash on a ``cpu`` hasher. All four reach validated seq 4
  with the same hash at every seq, and a payment submitted at a port
  validator and one submitted at a JAX validator land in ledgers with
  the same hash, balance and metadata on all four. A ``[peer_ssl]
  require`` pair, one of each package, handshakes over TLS (the hello's
  session hash binds the TLS channel, so HP_SESSION and the binding must
  be equal byte for byte) and closes.
- **The config.** The keys the port takes parse to the JAX
  ``Config``'s values (the fleet roles' and the health watchdog's among
  them); the keys of planes the port does not have still raise at parse
  (the JAX config takes them).
- **The pump's prefetch error propagates.** The JAX pump swallows an
  error of its batched prefetch and lets each transaction be verified
  again on its own; the port's ends the session, keeps the error for
  the node (``TcpOverlay.device_error``), and the node's heartbeat
  raises it.
- **Handshakes are counted apart.** The hello's session signature is
  the reference's host check; ``TcpOverlay.handshake_verifies`` counts
  it, and on a net whose traffic the verify plane answers, every host
  verify of the process is one of those: the round gives the agreed
  set's transactions their verdicts before the close apply, and
  re-checks the disputed ones on the plane in one batch.
- **Two faults of the JAX overlay, not copied.** Its pump loses every
  transaction of a read that carries two or more (the batched verify
  marks them seen before the suppression check), and it sends a
  disputed transaction again to every peer, each of which charges the
  re-send; on a private net whose validators share one address those
  charges throttle all transaction gossip. The port applies and relays
  each transaction of a read, and relays a transaction once.
- **Two faults of the JAX round's re-apply, not copied.** It re-applies
  the open ledger's transactions that missed the agreed set in the tx
  map's order, and the lost disputed ones in the disputes' order, so a
  run of one account's sequences is mostly held (and with a TxQ,
  dropped past ten an account): a burst from one account crawls into
  the ledgers a few a round. The port re-applies both in canonical
  order, each account's by sequence, as the reference does.
- **A ledger outside the history cache** answers from the node store
  (a fault the port had, fixed).
- **The kernels' build** runs once for the node processes of one net.
"""

from __future__ import annotations

import tempfile
import time
import types

import pytest

import stellard_tpu.node.config as jax_config
import stellard_tpu.overlay.peertls as jax_peertls
import stellard_tpu.overlay.tcp as jax_tcp
import stellard_tpu.overlay.wire as jax_wire
import stellard_tpu.protocol.keys as jax_keys
import stellard_tpu_torch.protocol.keys as port_keys
from stellard_tpu.protocol.formats import TxType
from stellard_tpu.protocol.sfields import sfAmount, sfBalance, sfDestination
from stellard_tpu.protocol.stamount import STAmount
from stellard_tpu.protocol.sttx import SerializedTransaction
from stellard_tpu_torch.crypto.backend import CpuHasher
from stellard_tpu_torch.node import config as port_config
from stellard_tpu_torch.node.node import Node as PortNode
from stellard_tpu_torch.node.verifyplane import VerifyPlane
from stellard_tpu_torch.overlay import peertls as port_peertls
from stellard_tpu_torch.overlay import tcp as port_tcp
from stellard_tpu_torch.overlay import wire as port_wire
from test_torch_tcp import net_deadline  # noqa: F401
from test_torch_txq import CpuConfig

MASTER = jax_keys.KeyPair.from_passphrase("masterpassphrase")
SPEED = 5.0
XRP = 1_000_000


def free_ports(n: int) -> list[int]:
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def wait_until(pred, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    return pred()


class Net:
    """Overlays of either package on one clock; the port's on cpu
    planes (stopped with the net)."""

    def __init__(self, packages, quorum, tls=None, tag="mixed"):
        n = len(packages)
        ports = free_ports(n)
        self.keys = [jax_keys.KeyPair.from_passphrase(f"{tag}-val-{i}") for i in range(n)]
        unl = {k.public for k in self.keys}
        t0 = time.monotonic()
        self.clock = lambda: (time.monotonic() - t0) * SPEED
        self.ntime = lambda: 50_000_000 + int(self.clock())
        self.planes, self.overlays = [], []
        for i, pkg in enumerate(packages):
            kw = {}
            if pkg == "port":
                plane = VerifyPlane(backend="cpu")
                self.planes.append(plane)
                kw = {"verify_many": plane.verify_many, "hash_batch": CpuHasher()}
            if tls is not None:
                peertls = port_peertls if pkg == "port" else jax_peertls
                kw["peer_tls"] = peertls.PeerTLS.from_state_dir(
                    tempfile.mkdtemp(prefix="tls-mixed-"), required=(tls == "require"))
            tcp = port_tcp if pkg == "port" else jax_tcp
            self.overlays.append(tcp.TcpOverlay(
                key=self.keys[i], unl=unl, quorum=quorum, port=ports[i],
                peer_addrs=[("127.0.0.1", ports[j]) for j in range(n) if j != i],
                network_time=self.ntime, clock=self.clock, timer_interval=0.15,
                idle_interval=4, **kw))
        genesis_close = self.ntime()
        for ov in self.overlays:
            ov.start(MASTER.account_id, close_time=genesis_close)

    def stop(self):
        for ov in self.overlays:
            ov.stop()
        for plane in self.planes:
            plane.stop()

    def validated_at_least(self, seq) -> bool:
        return all(ov.node.lm.validated is not None and ov.node.lm.validated.seq >= seq
                   for ov in self.overlays)

    def common_hashes(self) -> dict:
        """seq -> the set of hashes the overlays hold there, for every
        seq all of them have validated."""
        top = min(ov.node.lm.validated.seq for ov in self.overlays)
        return {seq: {ov.node.lm.ledger_history.get(seq) for ov in self.overlays}
                for seq in range(1, top + 1)}


def payment(seq: int, dest, drops: int, pkg) -> SerializedTransaction:
    """A signed payment from the master account, built by package
    ``pkg``'s protocol (its bytes are the same either way)."""
    tx = pkg.SerializedTransaction.build(
        pkg.TxType.ttPAYMENT, MASTER.account_id, seq, 10,
        {pkg.sfAmount: pkg.STAmount.from_drops(drops), pkg.sfDestination: dest.account_id})
    tx.sign(pkg.KeyPair.from_seed(MASTER.seed))
    return tx


def protocol_of(name: str) -> types.SimpleNamespace:
    import importlib

    def mod(m):
        return importlib.import_module(f"{name}.protocol.{m}")

    sf = mod("sfields")
    return types.SimpleNamespace(
        SerializedTransaction=mod("sttx").SerializedTransaction, TxType=mod("formats").TxType,
        sfAmount=sf.sfAmount, sfDestination=sf.sfDestination,
        STAmount=mod("stamount").STAmount, KeyPair=mod("keys").KeyPair)


def landed_everywhere(net, dest, drops):
    def check():
        for ov in net.overlays:
            led = ov.node.lm.validated
            if led is None:
                return False
            root = led.account_root(dest.account_id)
            if root is None:
                return False
            bal = root[sfBalance] if ov in net.jax else root[net.port_sf.sfBalance]
            if bal.drops() != drops:
                return False
        return True

    return check


def test_mixed_net_validates_the_same_hashes_and_payments():
    """2 JAX + 2 port validators, quorum 3: the same validated hash at
    every seq to 4 and beyond; a payment submitted at a port validator
    and one at a JAX validator each land in the same ledger, with the
    same hash, on all four."""
    import stellard_tpu_torch.protocol.sfields as port_sf

    net = Net(["jax", "port", "jax", "port"], quorum=3)
    net.jax = {net.overlays[0], net.overlays[2]}
    net.port_sf = port_sf
    try:
        assert wait_until(lambda: all(ov.peer_count() == 3 for ov in net.overlays), 30)
        assert wait_until(lambda: net.validated_at_least(4), 90), [
            ov.node.lm.validated and ov.node.lm.validated.seq for ov in net.overlays]
        assert all(len(hashes) == 1 for hashes in net.common_hashes().values())

        alice = jax_keys.KeyPair.from_passphrase("mixed-alice")
        bob = jax_keys.KeyPair.from_passphrase("mixed-bob")
        # submitted at a port validator, built with the port's protocol
        net.overlays[1].submit_client_tx(payment(1, alice, 1000 * XRP,
                                                 protocol_of("stellard_tpu_torch")))
        assert wait_until(landed_everywhere(net, alice, 1000 * XRP), 90)
        # submitted at a JAX validator, built with the JAX protocol
        net.overlays[2].submit_client_tx(payment(2, bob, 2000 * XRP, protocol_of("stellard_tpu")))
        assert wait_until(landed_everywhere(net, bob, 2000 * XRP), 90)
        hashes = net.common_hashes()
        assert all(len(h) == 1 for h in hashes.values()), hashes
        # the ledgers the payments landed in: one hash, on every validator
        for dest in (alice, bob):
            seqs = set()
            for ov in net.overlays:
                led = ov.node.lm.validated
                seq = next(s for s in range(2, led.seq + 1)
                           if ov.node.lm.get_ledger_by_seq(s).account_root(
                               dest.account_id) is not None)
                seqs.add((seq, ov.node.lm.ledger_history[seq]))
            assert len(seqs) == 1, seqs
    finally:
        net.stop()


def test_mixed_tls_pair_handshakes_and_closes():
    """A ``[peer_ssl] require`` pair, a JAX and a port validator: the
    session is TLS 1.2 on both sides, the hello signatures over the
    channel-bound session hash verify across the packages, and the pair
    closes and validates the same ledgers."""
    import ssl

    net = Net(["jax", "port"], quorum=2, tls="require", tag="mixed-tls")
    try:
        assert wait_until(lambda: all(ov.peer_count() == 1 for ov in net.overlays), 30)
        for ov in net.overlays:
            for p in ov.peers.values():
                assert isinstance(p.sock, ssl.SSLSocket)
                assert p.sock.cipher()[1] == "TLSv1.2"
        assert net.overlays[1].handshake_verifies >= 1
        assert wait_until(lambda: net.validated_at_least(3), 60)
        assert all(len(h) == 1 for h in net.common_hashes().values())
    finally:
        net.stop()


def test_session_domain_and_hello_frames_are_equal():
    """The session-signature domain, the protocol version and a hello's
    frame are the same bytes in both packages."""
    assert port_tcp.HP_SESSION == jax_tcp.HP_SESSION
    assert port_tcp.PROTO_VERSION == jax_tcp.PROTO_VERSION
    key = jax_keys.KeyPair.from_passphrase("hello-frame")
    fields = (1, 123, key.public, key.sign(bytes(32)), 7, bytes(range(32)), 51235)
    assert port_wire.frame(port_wire.Hello(*fields)) == jax_wire.frame(jax_wire.Hello(*fields))


# -- the config ------------------------------------------------------------------

LIFTED = {
    "[peer_port]\n51235\n[standalone]\n0\n[ips]\n127.0.0.1 51236\n10.0.0.2:51237\n"
    "[peer_ssl]\nrequire\n[clock_speed]\n1\n[network_time_offset]\n-7\n"
    "[validation_quorum]\n3\n": (
        "peer_port", "standalone", "ips", "peer_ssl", "clock_speed", "network_time_offset",
        "validation_quorum"),
    "[peer_ssl]\nallow\n": ("peer_ssl",),
    "[overlay]\nsquelch=3\nsquelch_rotate=5\nsendq_cap=64\nsendq_evict_drops=9\n": (
        "overlay_squelch", "overlay_squelch_rotate", "overlay_sendq_cap",
        "overlay_sendq_evict_drops"),
    "[cluster_nodes]\nn9KAa2zVWjPHgfzsE3iZ8HAbzJtPrnoh4H2M2HgE7dfqtvyEb1KJ\n": ("cluster_nodes",),
    "[rpc_secure]\n1\n[rpc_ssl_cert]\n/c.pem\n[rpc_ssl_key]\n/k.pem\n[websocket_secure]\n1\n": (
        "rpc_secure", "rpc_ssl_cert", "rpc_ssl_key", "websocket_secure"),
    "[sntp_servers]\ntime.example 123\npool.example\n": ("sntp_servers",),
    "[validators_file]\nvalidators.txt\n[validators_site]\nexample.com\n": (
        "validators_file", "validators_site"),
    # the out-of-core state's: history shards, online deletion, the
    # lazy trees' resident set
    "[node_db]\nshards=1": ("node_db_shards",),
    "[node_db]\nonline_delete=4": ("node_db_online_delete",),
    "[node_db]\nonline_delete=8\nonline_delete_interval=2\nsql_trim=0\nshards=/s\n": (
        "node_db_online_delete", "node_db_online_delete_interval", "node_db_sql_trim",
        "node_db_shards"),
    "[tree]\ncache_mb=2": ("tree_cache_mb",),
    # the fleet roles' and the health watchdog's
    "[node]\nmode=follower": ("node_mode", "node_upstream"),
    "[node]\nmode=archive": ("node_mode", "archive_path", "archive_backfill",
                             "archive_rescan_s"),
    "[health]\nenabled=1": (
        "health_enabled", "health_stall_warn_s", "health_stall_crit_s", "health_drift_factor",
        "health_lag_warn", "health_lag_crit", "health_fanout_p99_warn_ms", "health_flips_warn",
        "health_cache_hit_warn", "health_persist_depth_warn", "health_flight_dir",
        "health_flight_spans"),
    "[node]\nmode=follower\nupstream=127.0.0.1 51235\nupstream=10.0.0.2 51236\n": (
        "node_mode", "node_upstream"),
    "[node]\nmode=archive\nupstream=127.0.0.1:5005\n[archive]\npath=/a\nbackfill=0\n"
    "rescan_s=5\n": ("node_mode", "node_upstream", "archive_path", "archive_backfill",
                     "archive_rescan_s"),
    "[health]\nenabled=0\nstall_warn_s=20\nstall_crit_s=60\ndrift_factor=3\nlag_warn=5\n"
    "lag_crit=9\nflight_dir=/f\nflight_spans=64\n": (
        "health_enabled", "health_stall_warn_s", "health_stall_crit_s", "health_drift_factor",
        "health_lag_warn", "health_lag_crit", "health_flight_dir", "health_flight_spans"),
}
LIFTED["[spec]\nworkers=2"] = ("spec_workers", "spec_mode", "spec_max_retries",
                               "spec_drain_timeout_s", "spec_transport")
STILL_REFUSED = ("[kernel_tuning]\nKERNEL_TUNING.json",)


@pytest.mark.parametrize("text", sorted(LIFTED))
def test_lifted_keys_parse_to_the_jax_values(text):
    port, jax = port_config.Config.from_ini(text), jax_config.Config.from_ini(text)
    for name in LIFTED[text]:
        assert getattr(port, name) == getattr(jax, name), name


@pytest.mark.parametrize("text", STILL_REFUSED)
def test_unported_planes_still_raise(text):
    jax_config.Config.from_ini(text)  # a real key of the JAX config
    with pytest.raises(ValueError, match="not part of this package"):
        port_config.Config.from_ini(text)


# -- the pump's prefetch error -----------------------------------------------------


def relay_read(pkg_tcp, pkg_wire, blobs, calls, fail_batches=True):
    """A port or JAX overlay started on its own chain, with a verify
    plane that verifies on the host and, with ``fail_batches``, fails any
    batch of more than one signature; and a fake peer whose one socket
    read carries ``blobs`` as TxMessages."""
    def verify_many(reqs):
        calls.append(len(reqs))
        if fail_batches and len(reqs) > 1:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return [pkg_tcp.verify_signature(r.public, r.signing_hash, r.signature) for r in reqs]

    key = jax_keys.KeyPair.from_passphrase("pump-victim")
    ov = pkg_tcp.TcpOverlay(key=key, unl={key.public}, quorum=1, port=free_ports(1)[0],
                            peer_addrs=[], verify_many=verify_many)
    ov.node.start(MASTER.account_id, 50_000_000)
    reads = iter([b"".join(pkg_wire.frame(pkg_wire.TxMessage(b)) for b in blobs), b""])
    peer = types.SimpleNamespace(
        alive=True, reader=pkg_wire.FrameReader(), remote=("127.0.0.1", 1),
        node_public=b"\x02" * 33, uid=10_000, acq_replies=0, last_recv=0.0,
        recv_locked=lambda: next(reads), send=lambda data: None, close=lambda: None)
    return ov, peer


def test_pump_prefetch_error_propagates():
    """One read of two relayed payments: the port's pump raises
    DeviceFailed from the failed batch and keeps its cause for the node,
    with no per-transaction verify after it; the JAX pump swallows the
    error and verifies each payment again alone."""
    p = protocol_of("stellard_tpu")
    dest = jax_keys.KeyPair.from_passphrase("pump-dest")
    blobs = [payment(s, dest, 500 * XRP, p).serialize() for s in (1, 2)]
    calls = {"jax": [], "port": []}
    ov, peer = relay_read(jax_tcp, jax_wire, blobs, calls["jax"])
    try:
        ov._pump(peer)
    finally:
        ov.stop()
    assert calls["jax"] == [2, 1, 1]  # the batch failed; each tx again, alone
    ov, peer = relay_read(port_tcp, port_wire, blobs, calls["port"])
    try:
        with pytest.raises(port_tcp.DeviceFailed):
            ov._pump(peer)
        assert calls["port"] == [2]
        assert isinstance(ov.device_error, RuntimeError)
        assert "illegal memory access" in str(ov.device_error)
    finally:
        ov.stop()


def test_node_heartbeat_raises_the_overlays_device_error(tmp_path):
    """A networked port Node whose overlay kept a device error raises it
    from its heartbeat, so ``run()`` (the daemon's loop) ends."""
    cfg = CpuConfig(standalone=False, peer_port=free_ports(1)[0],
                    database_path=str(tmp_path / "tx.db"))
    node = PortNode(cfg).setup()
    try:
        assert node.ledger_master is node.overlay.node.lm
        node._overlay_heartbeat(time.monotonic())  # healthy: sets the mode
        node.overlay.device_error = RuntimeError("CUDA error: launch failed")
        with pytest.raises(RuntimeError, match="the card failed under the overlay"):
            node._overlay_heartbeat(time.monotonic())
    finally:
        node.stop()


# -- handshakes, counted apart -------------------------------------------------------


def test_handshakes_are_counted_apart_from_host_verifies():
    """Two port validators verifying on a cpu verify plane (the native
    verifier, which counts each signature of its batches), a payment
    submitted at each: every host verify the process makes while they
    connect, relay, propose, validate and close is a plane's or a
    hello's session signature, and each overlay counted its own. The agreed set's transactions take their
    verdicts before the close apply, and the disputed ones re-checked on
    accept go to the plane in one batch, so no transactor and no re-check
    verifies a signature on the host."""
    import chip_smoke as cs
    from stellard_tpu_torch.consensus.consensus import LedgerConsensus

    p = protocol_of("stellard_tpu_torch")
    before = port_keys.host_verifies
    rechecks = [0]
    with cs.counting_dispute_rechecks(LedgerConsensus, rechecks):
        net = Net(["port", "port"], quorum=2, tag="handshake")
        try:
            assert wait_until(lambda: net.validated_at_least(3), 60)
            dests = [jax_keys.KeyPair.from_passphrase(f"hs-dest-{i}") for i in range(2)]
            net.overlays[0].submit_client_tx(payment(1, dests[0], 1000 * XRP, p))
            net.overlays[1].submit_client_tx(payment(2, dests[1], 1000 * XRP, p))
            seq = max(ov.node.lm.validated.seq for ov in net.overlays)
            assert wait_until(lambda: all(
                ov.node.lm.validated.account_root(d.account_id) is not None
                for ov in net.overlays for d in dests), 60)
            assert wait_until(lambda: net.validated_at_least(seq + 1), 60)
            assert all(plane.verified > 0 for plane in net.planes)
        finally:
            net.stop()
    counted = [ov.handshake_verifies for ov in net.overlays]
    assert all(n >= 1 for n in counted), counted
    assert port_keys.host_verifies - before == sum(counted) + sum(
        plane.verified for plane in net.planes)


# -- a ledger out of the history cache -------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_ledger_by_index_outside_the_cache_answers_from_the_store(pkg, tmp_path):
    """`ledger` by index for a closed ledger that is no longer in the
    history cache is rebuilt from the node store: the same hash as
    before (the JAX node loads it lazily, the port's eagerly). The port
    used to pass the JAX loader's lazy and cold options, which its
    eager Ledger.load does not take, and answered `internal`; the tcp
    phase's validators met it when a catch-up left a validated ledger
    out of their caches."""
    import importlib

    root = "stellard_tpu" if pkg == "jax" else "stellard_tpu_torch"
    handlers = importlib.import_module(f"{root}.rpc.handlers")
    node_cls = importlib.import_module(f"{root}.node.node").Node
    config = jax_config.Config if pkg == "jax" else CpuConfig
    node = node_cls(config(standalone=True, database_path=str(tmp_path / "tx.db"))).setup()
    try:
        for _ in range(4):
            node.close_ledger()

        def ledger(seq):
            ctx = handlers.Context(node=node, params={"ledger_index": seq},
                                   role=handlers.Role.ADMIN)
            return handlers.dispatch(ctx, "ledger")

        before = ledger(3)["ledger"]["hash"]
        node.ledger_master.ledgers_by_hash._data.clear()
        assert node.ledger_master.get_ledger_by_seq(3) is None
        assert ledger(3)["ledger"]["hash"] == before
    finally:
        node.stop()


# -- the kernels' build, shared by the node processes of one net -------------------


def test_node_processes_build_each_kernel_once(tmp_path):
    """Three processes that start together and load the same kernel
    library (a net's validators on one card): one runs the compiler, the
    others wait on the build directory's lock and load what it built.
    The compiler here is a stand-in that counts its runs and writes an
    empty file where nvcc would write the library."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    fake = tmp_path / "nvcc"
    runs = tmp_path / "runs"
    fake.write_text(
        "#!/bin/sh\n"
        f"echo run >> {runs}\n"
        "sleep 1\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        ': > "$2"\n')
    fake.chmod(0o755)
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(repo)!r})\n"
        "from pathlib import Path\n"
        "from stellard_tpu_torch.ops import build\n"
        f"build.BUILD_DIR = Path({str(tmp_path / 'build')!r})\n"
        f"build.nvcc_path = lambda: {str(fake)!r}\n"
        "build.build(['sha512'])\n"
        "print(build._lib_path('sha512').exists())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert outs == ["True"] * 3
    assert runs.read_text().split() == ["run"]


# -- two faults of the JAX overlay that the port does not copy -------------------


def sent_frames(ov, peers=None):
    """Fake peers (uids 1-3) on ``ov`` whose sends are kept, by uid
    (each fake peer put in ``peers`` by uid when given)."""
    out = {}
    for uid in (1, 2, 3):
        out[uid] = []
        peer = types.SimpleNamespace(uid=uid, alive=True, node_public=bytes([uid]) * 32,
                                     remote=("127.0.0.1", uid), send=out[uid].append,
                                     close=lambda: None)
        ov.peers[peer.node_public] = peer
        if peers is not None:
            peers[uid] = peer
    return out


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_every_tx_of_one_read_is_applied_and_relayed(pkg):
    """One socket read carrying two relayed payments: the port applies
    both to its open ledger and relays both to its other peers. The JAX
    pump records the batched verdicts in the HashRouter before its
    suppression check, which then takes both for already seen: neither
    is applied nor relayed."""
    p = protocol_of("stellard_tpu")
    dest = jax_keys.KeyPair.from_passphrase("read-dest")
    blobs = [payment(s, dest, 500 * XRP, p).serialize() for s in (1, 2)]
    tcp, wire = (jax_tcp, jax_wire) if pkg == "jax" else (port_tcp, port_wire)
    calls: list = []
    ov, peer = relay_read(tcp, wire, blobs, calls, fail_batches=False)
    try:
        sent = sent_frames(ov)
        calls.clear()
        ov._pump(peer)
        open_ids = {txid for txid, _b, _m in ov.node.lm.current_ledger().tx_entries()}
        ids = {p.SerializedTransaction.from_bytes(b).txid() for b in blobs}
        relayed = sum(len(frames) for frames in sent.values())
    finally:
        ov.stop()
    assert calls == [2]  # one batched verify of the read
    if pkg == "port":
        assert open_ids == ids and relayed == 2 * 3
    else:
        assert open_ids == set() and relayed == 0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_tx_is_relayed_once(pkg):
    """A tx relayed on arrival and then disputed in consensus: the port
    sends it to each peer once, never back to the peer it came from; the
    JAX overlay broadcasts the disputed tx again to every peer, each of
    which charges the re-send as a duplicate flood."""
    p = protocol_of("stellard_tpu")
    dest = jax_keys.KeyPair.from_passphrase("relay-dest")
    blob = payment(1, dest, 500 * XRP, p).serialize()
    tcp, wire = (jax_tcp, jax_wire) if pkg == "jax" else (port_tcp, port_wire)
    ov, _peer = relay_read(tcp, wire, [], [], fail_batches=False)
    try:
        peers: dict = {}
        sent = sent_frames(ov, peers)
        ov._dispatch(peers[1], wire.TxMessage(blob))  # arrives from peer 1
        ov.relay_disputed_tx(blob)
        counts = {uid: len(frames) for uid, frames in sent.items()}
    finally:
        ov.stop()
    if pkg == "port":
        assert counts == {1: 0, 2: 1, 3: 1}
    else:
        assert counts == {1: 1, 2: 2, 3: 2}  # back to its sender, and twice


def test_the_close_apply_checks_no_signature_on_the_host():
    """A round's agreed set parses to fresh transactions; the port gives
    each the verdict its validator already holds (the HashRouter's, from
    the plane) before the close apply, so the serial transactor checks
    no signature on the host. The JAX round checks each one that does
    not splice on the host."""
    p = protocol_of("stellard_tpu_torch")
    dest = jax_keys.KeyPair.from_passphrase("close-dest")
    calls: list = []
    ov, _peer = relay_read(port_tcp, port_wire, [], calls, fail_batches=False)
    try:
        vn = ov.node
        vn.lm.delta_replay = False  # every tx through the serial transactor
        ter, _applied = vn.submit(payment(1, dest, 500 * XRP, p))
        assert int(ter) == 0 and calls == [1]  # verified on the plane
        rnd = vn.round
        rnd.close_ledger()
        before = port_keys.host_verifies
        rnd.accept(rnd.our_close_time, True)
        assert port_keys.host_verifies == before
        assert vn.lm.closed_ledger().account_root(dest.account_id) is not None
    finally:
        ov.stop()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_cut_burst_is_reapplied_in_sequence_order(pkg):
    """40 consecutive sequences of one account in the open ledger, a
    close whose agreed set holds the first 10: the port re-applies the
    other 30 to the next open ledger in sequence order, as the
    reference's canonical set does. The JAX package takes the tx map's
    (hash) order, so most meet terPRE_SEQ and go to the held pile (with
    a TxQ, ten an account are kept and the rest dropped, though the door
    answered tesSUCCESS)."""
    p = protocol_of("stellard_tpu" if pkg == "jax" else "stellard_tpu_torch")
    dest = jax_keys.KeyPair.from_passphrase("burst-dest")
    tcp, wire = (jax_tcp, jax_wire) if pkg == "jax" else (port_tcp, port_wire)
    ov, _peer = relay_read(tcp, wire, [], [], fail_batches=False)
    try:
        lm = ov.node.lm
        txs = [payment(s, dest, 500 * XRP, p) for s in range(1, 41)]
        assert all(int(ov.node.submit(tx)[0]) == 0 for tx in txs)
        lm.close_with_txset(txs[:10], 50_000_100, 10)
        open_ids = {txid for txid, _b, _m in lm.current_ledger().tx_entries()}
        reapplied = sum(tx.txid() in open_ids for tx in txs[10:])
        held = len(lm.held)
    finally:
        ov.stop()
    if pkg == "port":
        assert (reapplied, held) == (30, 0)
    else:
        assert (reapplied, held) == (3, 27)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_lost_disputes_are_reapplied_in_sequence_order(pkg):
    """A round that loses 30 disputed payments of one account, none of
    them in this validator's open ledger (a peer proposed them): the port
    re-applies all 30 to the next open ledger in sequence order, as the
    reference's canonical set does. The JAX round takes the disputes'
    order (here the highest sequence first), so all but one meet
    terPRE_SEQ and are held; on a net that run then crawls into the
    ledgers a few a round."""
    import importlib

    p = protocol_of("stellard_tpu" if pkg == "jax" else "stellard_tpu_torch")
    disputed = importlib.import_module(
        ("stellard_tpu" if pkg == "jax" else "stellard_tpu_torch") + ".consensus.disputed")
    dest = jax_keys.KeyPair.from_passphrase("dispute-dest")
    tcp, wire = (jax_tcp, jax_wire) if pkg == "jax" else (port_tcp, port_wire)
    ov, _peer = relay_read(tcp, wire, [], [], fail_batches=False)
    try:
        vn = ov.node
        txs = [payment(s, dest, 500 * XRP, p) for s in range(1, 31)]
        rnd = vn.round
        rnd.close_ledger()
        for tx in reversed(txs):
            rnd.disputes[tx.txid()] = disputed.DisputedTx(tx.txid(), tx.serialize(), False)
        rnd.accept(rnd.our_close_time, True)
        open_ids = {txid for txid, _b, _m in vn.lm.current_ledger().tx_entries()}
        reapplied = sum(tx.txid() in open_ids for tx in txs)
        held = len(vn.lm.held)
    finally:
        ov.stop()
    if pkg == "port":
        assert (reapplied, held) == (30, 0)
    else:
        assert (reapplied, held) == (1, 29)
